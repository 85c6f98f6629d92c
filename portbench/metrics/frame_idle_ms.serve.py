"""Milliseconds a served batch in which the card idles while the host is
in the program's Frame path (its spans ``alo.frame.*``,
``alo.aug.resize`` and ``alo.spatial.batch_list``; the benchmark's own
upload of the frames is outside them), over the trace with host ops."""

from portbench.reference.spans import idle_ms_under

SPANS = ("alo.frame.", "alo.aug.resize", "alo.spatial.batch_list")


def read(r):
    return idle_ms_under(r, SPANS)
