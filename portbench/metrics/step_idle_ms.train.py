"""Milliseconds a train step in which the card idles while the host is in
the step's forward, criterion, backward or optimizer step (the program's
spans ``alo.trainer.forward``, ``.criterion``, ``.backward`` and
``.optimizer``, and the spans they enclose), over the trace with host
ops."""

from portbench.reference.spans import idle_ms_under

SPANS = ("alo.trainer.forward", "alo.trainer.criterion",
         "alo.trainer.backward", "alo.trainer.optimizer")


def read(r):
    return idle_ms_under(r, SPANS)
