"""The closest-hit legs' share of their roofline, in percent: the least
time the legs of the last traced frame need on the card (roofline.py,
from each leg's inputs and returned distances alone) over the busy time
of the trace kernels launched inside those legs."""

import roofline


def read(ctx):
    peaks = roofline.peaks_of(ctx["kind"])
    if peaks is None or not ctx["legs"] or ctx["closest_kernel_us"] <= 0:
        return None
    need = 0.0
    by = {"ops": 0, "bytes": 0}
    for o, d, t_max, active, t, face in ctx["legs"]:
        work = roofline.leg_work(o, d, t_max, active, t, face, ctx["box"],
                                 ctx["face_id"])
        s, which = roofline.bound_s(work, peaks)
        need += s
        by[which] += 1
    ctx["notes"].append(
        f"closest_hit_roofline: {len(ctx['legs'])} legs, bound "
        f"{need * 1e3:.6f} ms by ops on {by['ops']} and by bytes on "
        f"{by['bytes']}; kernels {ctx['closest_kernel_us'] / 1e3:.6f} ms")
    return 100.0 * need / (ctx["closest_kernel_us"] / 1e6)
