"""The PyTorch port's TensorBoard logger (``train/logger.py``, the event
file written by hand) against the JAX package's ``TensorBoardLogger``
(tensorboardX): the same calls give records with the same tags, steps and
values, read back by TensorBoard's own loaders; the CRC-32C and TFRecord
framing against known answers; ``make_logger``."""

import glob
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from aloception_tpu.train.logger import TensorBoardLogger as JaxLogger
from aloception_tpu_torch.train import logger as tlog
from tensorboard.backend.event_processing.event_file_loader import (
    LegacyEventFileLoader)


def calls(log):
    """The same calls on either logger."""
    rng = np.random.RandomState(0)
    log.log_scalar("loss", 1.5, 3)
    log.log_scalar("/lead/slash", -2.25, 3)
    log.log_scalars({"a": 1, "b": "not a number", "c d": np.float32(2.5),
                     "e": None}, 4, prefix="train/")
    log.log_image("val/img", rng.rand(5, 7, 3).astype(np.float32), 5)
    log.log_image("val/grey", rng.rand(6, 4, 1), 5)
    log.log_hist("weights", rng.randn(1000), 6)
    log.log_hist("counts", rng.randint(0, 5, 50), 7)
    log.flush()
    log.close()


def events(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*tfevents*"))
    return list(LegacyEventFileLoader(path).Load())


def test_event_file_matches_tensorboardx(tmp_path):
    calls(tlog.TensorBoardLogger(str(tmp_path / "port")))
    calls(JaxLogger(str(tmp_path / "jax")))
    got, want = events(str(tmp_path / "port")), events(str(tmp_path / "jax"))
    assert got[0].file_version == want[0].file_version == "brain.Event:2"
    got, want = got[1:], want[1:]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        (gv,), (wv,) = g.summary.value, w.summary.value
        assert (gv.tag, g.step) == (wv.tag, w.step)
        kind = gv.WhichOneof("value")
        assert kind == wv.WhichOneof("value")
        if kind == "simple_value":
            assert gv.simple_value == wv.simple_value
        elif kind == "histo":
            assert gv.histo == wv.histo
        else:
            gi, wi = gv.image, wv.image
            assert (gi.height, gi.width, gi.colorspace) == (
                wi.height, wi.width, wi.colorspace)
            decode = [np.asarray(Image.open(io.BytesIO(i.encoded_image_string)))
                      for i in (gi, wi)]
            np.testing.assert_array_equal(*decode)
        assert abs(g.wall_time - w.wall_time) < 60


def test_crc32c_and_record_framing():
    """CRC-32C's check value (RFC 3720's "123456789" -> 0xE3069283) and
    others, and a TFRecord's framing: the length, its masked CRC, the data,
    its masked CRC."""
    assert tlog.crc32c(b"123456789") == 0xE3069283
    assert tlog.crc32c(b"") == 0
    assert tlog.crc32c(bytes(32)) == 0x8A9136AA
    assert tlog.crc32c(bytes([0xFF] * 32)) == 0x62A8AB43
    crc = tlog.crc32c(b"abc")
    assert tlog.masked_crc32c(b"abc") == (
        ((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    rec = tlog.tfrecord(b"hello")
    assert struct.unpack("<Q", rec[:8])[0] == 5
    assert struct.unpack("<I", rec[8:12])[0] == tlog.masked_crc32c(rec[:8])
    assert rec[12:17] == b"hello"
    assert struct.unpack("<I", rec[17:])[0] == tlog.masked_crc32c(b"hello")


def test_make_logger(tmp_path):
    assert isinstance(tlog.make_logger(None), tlog.NoOpLogger)
    assert isinstance(tlog.make_logger("none"), tlog.NoOpLogger)
    for name in ("tensorboard", "tb"):
        log = tlog.make_logger(name, str(tmp_path / name))
        assert isinstance(log, tlog.TensorBoardLogger)
        log.close()
    with pytest.raises(ValueError, match="log_dir"):
        tlog.make_logger("tensorboard")
    with pytest.raises(ValueError, match="unknown"):
        tlog.make_logger("visdom", str(tmp_path))


def test_figure_and_scatter_need_matplotlib(tmp_path):
    """``log_scatter`` draws through matplotlib when it is there, and raises
    with the reason when it is not."""
    log = tlog.TensorBoardLogger(str(tmp_path))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="matplotlib"):
            log.log_scatter("s", [0, 1], [1, 0], 1)
    else:
        log.log_scatter("s", [0, 1, 2], [1, 0, 2], 1)
        log.close()
        (image,) = [e for e in events(str(tmp_path)) if e.HasField("summary")]
        assert image.summary.value[0].tag == "s"
        assert image.summary.value[0].image.colorspace == 4
