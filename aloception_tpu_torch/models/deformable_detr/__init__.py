from .deformable_detr import (DeformableDETR, deformable_detr_r50,  # noqa: F401
                              inference)
from .ms_deform_attn import MSDeformAttn  # noqa: F401
from .deformable_transformer import DeformableTransformer  # noqa: F401
from .criterion import (deformable_criterion, focal_hungarian_match,  # noqa: F401
                        sigmoid_focal_loss)


def deformable_detr_r50_finetune(num_classes: int, with_box_refine: bool = True,
                                 **kwargs):
    """A Deformable-DETR-R50 with a fresh class head of ``num_classes``; graft
    pretrained weights with ``models.detr.finetune.finetune_params``."""
    return deformable_detr_r50(num_classes=num_classes,
                               with_box_refine=with_box_refine, **kwargs)
