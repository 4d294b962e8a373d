"""Host ms of the window's frames that ran eager or captured a graph (a
capacity key met for the first or second time), summed, over every frame
of the window outside the traced stretch: ms a frame."""


def read(r):
    frames = [f for f in r.frames if f["method"] != "raised"]
    if not frames:
        return None
    return sum(f["ms"] for f in frames if f["method"] in ("eager", "capture")) / len(frames)
