"""Milliseconds a served batch in which the card idles while the host is
in RAFT's forward (the program's spans ``alo.raft.*``: encoders,
correlation, each step's lookup and update, upsampling), over the trace
with host ops."""

from portbench.reference.spans import host_spans, idle_ms_under

SPANS = ("alo.raft.",)


def read(r):
    if not any(name.startswith(SPANS) for _, _, name
               in host_spans(r["host_trace"])):
        return None
    return idle_ms_under(r, SPANS)
