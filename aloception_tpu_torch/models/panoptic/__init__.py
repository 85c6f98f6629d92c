from .panoptic_head import (DetrPanoptic, MaskHeadSmallConv,  # noqa: F401
                            MHAttentionMap, PanopticHead,
                            inference_with_masks)
