"""The benchmark's plain reference of a frame (``frame.render``)."""
