"""Milliseconds a served batch in which the card idles while the host is
in the model's transformer (the program's span ``alo.model.transformer``),
over the trace with host ops."""

from portbench.reference.spans import idle_ms_under

SPANS = ("alo.model.transformer",)


def read(r):
    return idle_ms_under(r, SPANS)
