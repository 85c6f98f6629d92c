"""Host milliseconds a batch spends in the frame path: from the frames
handed in to the model's call (the benchmark's own span, every batch of the
window)."""


def read(r):
    spans = r["spans"].get("frame path")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
