from .criterion import (dice_loss, focal_mask_loss, loss_masks,  # noqa: F401
                        panoptic_criterion)
from .panoptic_head import (DetrPanoptic, MaskHeadSmallConv,  # noqa: F401
                            MHAttentionMap, PanopticHead,
                            inference_with_masks)
