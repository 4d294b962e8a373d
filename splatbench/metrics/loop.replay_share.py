"""Share of the window's frames (outside the traced stretch) that the
frame loop replayed from a captured graph (``Renderer.last_method``), %."""


def read(r):
    frames = [f for f in r.frames if f["method"] != "raised"]
    if not frames:
        return None
    return 100.0 * sum(f["method"] == "replay" for f in frames) / len(frames)
