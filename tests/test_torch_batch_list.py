"""``batch_list`` of the PyTorch port against a plain reference written
here: each frame padded with ``torch.nn.functional.pad`` at the bottom and
right with its normalization's black, then ``torch.cat``; the mask built
the same way. Payload and mask must be equal bit for bit; children must
equal what ``pad`` and ``_cat_batched`` make of them. Also the host work
that ``batch_list`` dispatches, and the cache of mean/std tensors."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import aloception_tpu_torch.aloscene as tsc
from aloception_tpu_torch.aloscene import frame as frame_module
from aloception_tpu_torch.aloscene.frame import RESNET_MEAN_STD
from aloception_tpu_torch.aloscene.spatial import _cat_batched

SIZES = ((12, 16), (9, 20), (16, 11), (7, 7))


def black(f):
    """The pad value of a frame's normalization, one float a channel."""
    c = f.size("C")
    if f.normalization in ("255", "01"):
        return [0.0] * c
    if f.normalization == "minmax_sym":
        return [-1.0] * c
    mean, std = (torch.tensor(v, dtype=torch.float32) for v in f.mean_std)
    return ((0.0 - mean) / std).tolist()


def plain(frames, size=None):
    """(payload, mask) of the batch: F.pad of each frame, then cat."""
    H = size[0] if size else max(f.H for f in frames)
    W = size[1] if size else max(f.W for f in frames)
    payloads, masks = [], []
    for f in frames:
        x = f.array if f.has_dim("B") else f.array[None]
        pads = (0, W - f.W, 0, H - f.H)
        payloads.append(torch.stack([
            F.pad(x[:, c], pads, value=v)
            for c, v in enumerate(black(f))], 1))
        masks.append(F.pad(torch.zeros(x.shape[0], 1, f.H, f.W), pads,
                           value=1.0))
    return torch.cat(payloads), torch.cat(masks)


def frame(h, w, norm="255", dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (3, h, w), generator=g).to(dtype)
    f = tsc.Frame(x)
    if norm == "01":
        return f.norm01()
    if norm == "minmax_sym":
        return f.norm_minmax_sym()
    if norm == "resnet":
        return f.norm_resnet()
    return f


def mixed(norm="255", dtype=torch.float32, sizes=SIZES):
    return [frame(h, w, norm, dtype, seed=i)
            for i, (h, w) in enumerate(sizes)]


CASES = {
    "255-uint8": lambda: (mixed("255", torch.uint8), {}),
    "255-uint8-size": lambda: (mixed("255", torch.uint8), {"size": (20, 24)}),
    "255-float": lambda: (mixed("255"), {}),
    "01": lambda: (mixed("01"), {"size": (16, 21)}),
    "minmax_sym": lambda: (mixed("minmax_sym"), {}),
    "resnet": lambda: (mixed("resnet"), {}),
    "resnet-size": lambda: (mixed("resnet"), {"size": (18, 24)}),
    "fill-the-slot": lambda: (mixed("resnet", sizes=[(12, 16)] * 3), {}),
    "fill-the-slot-size": lambda: (mixed("255", torch.uint8,
                                         sizes=[(12, 16)] * 2),
                                   {"size": (12, 16)}),
    "some-fill-the-slot": lambda: (mixed("resnet", sizes=[(12, 16), (8, 16),
                                                          (12, 16)]), {}),
    "intersection-norms": lambda: (
        [frame(12, 16, "resnet"), frame(9, 20, "01", seed=1),
         frame(16, 11, "minmax_sym", seed=2), frame(7, 7, "resnet", seed=3)],
        {"intersection": True}),
    "batched": lambda: (
        [tsc.batch_list(mixed("resnet", sizes=SIZES[:2])),
         frame(16, 11, "resnet", seed=5).batch()],
        {"size": (20, 24)}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_list_against_plain(case):
    frames, kwargs = CASES[case]()
    if case == "batched":   # a batch of two (with its mask) and one frame
        frames[0].mask = None
    got = tsc.batch_list(frames, **kwargs)
    want_x, want_m = plain(frames, kwargs.get("size"))
    assert got.names == ("B", "C", "H", "W")
    assert got.array.dtype == want_x.dtype
    assert torch.equal(got.array, want_x)
    assert got.mask.names == got.names
    assert torch.equal(got.mask.array, want_m)
    if kwargs.get("intersection"):
        assert got.normalization is None and got.mean_std is None
    else:
        assert got.normalization == frames[0].normalization
        assert got.mean_std == frames[0].mean_std


def test_batch_list_dict_forms():
    """A dict of frame lists, and a list of dicts, are batched per key."""
    left, right = mixed("resnet"), mixed("01", sizes=SIZES[::-1])
    for batch in (tsc.batch_list({"left": left, "right": right},
                                 size=(16, 20)),
                  tsc.batch_list([{"left": a, "right": b}
                                  for a, b in zip(left, right)],
                                 size=(16, 20))):
        assert batch.keys() == {"left", "right"}
        for key, frames in (("left", left), ("right", right)):
            want_x, want_m = plain(frames, (16, 20))
            assert torch.equal(batch[key].array, want_x)
            assert torch.equal(batch[key].mask.array, want_m)


def same(got, want):
    """Equal type, names, properties, payload, scores and children,
    recursively, bit for bit."""
    if want is None or isinstance(want, (dict, list)):
        assert type(got) is type(want)
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            for k in want:
                same(got[k], want[k])
        elif isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                same(g, w)
        return
    assert type(got) is type(want)
    assert got.names == want.names
    assert got._properties == want._properties
    assert torch.equal(got.array, want.array)
    if isinstance(want, tsc.Labels):
        assert (got.scores is None) == (want.scores is None)
        if want.scores is not None:
            assert torch.equal(got.scores, want.scores)
    assert got._children.keys() == want._children.keys()
    for k in want._children:
        same(got._children[k], want._children[k])


def labelled(h, w, seed):
    """A resnet frame with boxes (labels with scores), frame labels with
    scores and a flow with its occlusion."""
    g = torch.Generator().manual_seed(seed)
    f = frame(h, w, "resnet", seed=seed)
    n = 2 + seed % 3
    boxes = torch.rand(n, 4, generator=g) * 0.4 + 0.2
    ids = torch.arange(n, dtype=torch.float32)
    f.append_boxes2d(tsc.BoundingBoxes2D(
        boxes, boxes_format="xcyc", absolute=False,
        labels=tsc.Labels(ids, scores=ids / 10)))
    f.append_labels(tsc.Labels(torch.tensor([1.0, 2.0 + seed]),
                               scores=torch.tensor([0.5, 0.25])))
    occlusion = tsc.Mask(torch.rand(1, h, w, generator=g).round(),
                         names=("C", "H", "W"))
    f.append_flow(tsc.Flow(torch.randn(2, h, w, generator=g),
                           occlusion=occlusion))
    return f


@pytest.mark.parametrize("pad_boxes", [False, True])
@pytest.mark.parametrize("size", [None, (20, 24)])
def test_batch_list_children(pad_boxes, size):
    """Boxes (moved or recorded in ``padded_size``), labels with scores and
    flow (with its occlusion) come out as ``pad`` then ``_cat_batched``
    make them; the payload and mask as the plain reference's."""
    frames = [labelled(h, w, i) for i, (h, w) in enumerate(SIZES)]
    H = size[0] if size else max(f.H for f in frames)
    W = size[1] if size else max(f.W for f in frames)
    got = tsc.batch_list(frames, pad_boxes=pad_boxes, size=size)
    want = _cat_batched([f.batch().pad((0, H - f.H), (0, W - f.W),
                                       pad_boxes=pad_boxes) for f in frames])
    want_x, want_m = plain(frames, size)
    assert torch.equal(got.array, want_x)
    assert torch.equal(got.mask.array, want_m)
    assert isinstance(got.boxes2d, list) and isinstance(got.flow, list)
    assert got.labels.names == ("B", "N")
    for name in ("boxes2d", "labels", "flow"):
        same(got._children[name], want._children[name])
    # the frames themselves are left as they were
    assert all(f.boxes2d.padded_size is None for f in frames)
    assert all(not f.has_dim("B") for f in frames)


def test_batch_list_errors():
    f1 = labelled(12, 16, 0)
    bare = frame(9, 20, "resnet")
    with pytest.raises(ValueError, match="missing on some tensors"):
        tsc.batch_list([f1, bare])
    assert tsc.batch_list([f1, bare], intersection=True).labels is None
    with pytest.raises(ValueError, match="property 'normalization'"):
        tsc.batch_list([frame(12, 16, "resnet"), frame(12, 16, "01")])
    with pytest.raises(ValueError, match="smaller than"):
        tsc.batch_list(mixed(), size=(8, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tsc.batch_list([frame(12, 16), tsc.Frame(torch.zeros(1, 12, 16))])


class Dispatched(TorchDispatchMode):
    """Counts the aten ops dispatched, and apart those that return no
    view (they write memory)."""

    def __init__(self):
        super().__init__()
        self.ops = self.writes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.writes += not func.is_view
        return func(*args, **(kwargs or {}))


def test_batch_list_host_work():
    """32 childless frames, each smaller than its slot in H and W: at most
    a slot copy and a mask write a frame, 8 ops a frame in all, plus a
    constant for the buffers and the one fill."""
    frames = [frame(6 + i % 5, 8 + (3 * i) % 7, "resnet", seed=i)
              for i in range(32)]
    tsc.batch_list(frames, size=(16, 16))
    with Dispatched() as d:
        tsc.batch_list(frames, size=(16, 16))
    assert d.writes <= 2 * 32 + 8, d.writes
    assert d.ops <= 8 * 32 + 8, d.ops


def test_mean_std_made_once_per_device():
    """The resnet mean and std are made once on a device; norm_resnet and
    batch_list take views of them and write into none."""
    made = tsc.Frame._mean_std_arrays
    frame_module._mean_std_consts.cache_clear()
    made.made = 0
    x = torch.randint(0, 256, (3, 10, 14), dtype=torch.uint8)
    tsc.batch_list([tsc.Frame(x).norm_resnet()] * 2, size=(16, 16))
    assert made.made == 2
    for _ in range(10):
        fs = [tsc.Frame(x).norm_resnet(), tsc.Frame(x[:, :8]).norm_resnet()]
        tsc.batch_list(fs, size=(16, 16))
    assert made.made == 2
    mean, std, fill = frame_module._mean_std_consts(
        RESNET_MEAN_STD, torch.device("cpu"))
    want_mean, want_std = (torch.tensor(v, dtype=torch.float32)
                           for v in RESNET_MEAN_STD)
    assert torch.equal(mean, want_mean) and torch.equal(std, want_std)
    assert torch.equal(fill, (0.0 - want_mean) / want_std)
    assert made.made == 2


def test_mean_std_under_inference_mode_then_autograd():
    """Constants first made under inference mode serve a frame that needs
    its gradient afterwards."""
    frame_module._mean_std_consts.cache_clear()
    with torch.inference_mode():
        tsc.Frame(torch.rand(3, 4, 4) * 255).norm_resnet()
    x = (torch.rand(3, 4, 4) * 255).requires_grad_()
    tsc.Frame(x).norm_resnet().array.sum().backward()
    assert x.grad is not None
