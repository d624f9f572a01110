"""The share of the traced frames' device span, in percent, in which no
operation ran on the card: 100 x (1 - busy / span), where busy is the
union of the device operations' intervals and the span runs from the
first one's start to the last one's end."""


def read(ctx):
    if ctx["gpu_span_us"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_us"] / ctx["gpu_span_us"])
