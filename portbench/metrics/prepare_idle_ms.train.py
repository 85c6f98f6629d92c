"""Milliseconds a train step in which the card idles while the host is in
the Trainer's ``prepare_batch`` or ``to_device`` (the program's spans
``alo.trainer.prepare_batch`` and ``alo.trainer.to_device``), over the
trace with host ops."""

from portbench.reference.spans import idle_ms_under

SPANS = ("alo.trainer.prepare_batch", "alo.trainer.to_device")


def read(r):
    return idle_ms_under(r, SPANS)
