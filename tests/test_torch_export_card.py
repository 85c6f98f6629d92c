"""The export subsystem on the card: a Deformable-DETR-R50 package launches
the hand-written MSDA kernel from its compiled code. Imports no JAX, so it
runs where the JAX package cannot be imported:
``python -m pytest --noconftest tests/test_torch_export_card.py -m cuda``."""

import pytest
import torch

from aloception_tpu_torch import export as texport
from aloception_tpu_torch.ops.cuda import ms_deform_attn_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_package_launches_the_kernel_on_card(cuda, tmp_path):
    """Deformable-DETR-R50 + refine exported and compiled for the card: the
    package launches the hand-written MSDA kernel 12 times a forward (6
    encoder and 6 decoder layers) and agrees with eager."""
    from aloception_tpu_torch.models.deformable_detr import deformable_detr_r50
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = deformable_detr_r50(with_box_refine=True, device=cuda)
    exporter = texport.DeformableDetrExporter(model, input_shape=(128, 160))
    artifact = exporter.export_engine(path=str(tmp_path / "dd.pt2"))
    executor = texport.Executor(artifact)
    images = torch.randn(1, 128, 160, 3, device=cuda)
    mask = torch.zeros(1, 128, 160, device=cuda)
    before = ms_deform_attn_cuda.launches
    with torch.no_grad():
        got = executor(images, mask)
        torch.cuda.synchronize()
        assert ms_deform_attn_cuda.launches == before + 12
        want = exporter.build_fn()(images, mask)
    for k in want:
        ref = max(1.0, want[k].abs().max().item())
        assert (got[k] - want[k]).abs().max().item() <= 1e-3 * ref
