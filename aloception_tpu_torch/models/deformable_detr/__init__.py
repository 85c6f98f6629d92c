from .deformable_detr import (DeformableDETR, deformable_detr_r50,  # noqa: F401
                              inference)
from .ms_deform_attn import MSDeformAttn  # noqa: F401
from .deformable_transformer import DeformableTransformer  # noqa: F401
