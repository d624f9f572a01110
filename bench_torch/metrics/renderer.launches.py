"""Device operations (kernels, copies, fills) of the traced frames, per
frame: what ``Renderer.step`` makes the card run."""


def read(ctx):
    if not ctx["launches"]:
        return None
    return ctx["launches"] / ctx["frames"]
