"""PyTorch port: BASELINE config #3 and config #5 as the benchmark runs
them (bench_torch/), on the CPU at 32x16.

* ``stress44k_1080p.envis``: the main path's 44,556-face stress scene
  lit by the procedural sky written into a 4096x2048 equirect map, under
  env importance sampling and MIS (config #3's stand-ins);
* config #5: the 1M-triangle scene in 8 slabs, ``stress1m_4k.nee`` with
  next-event estimation of the lights (K3's any-hit walk, as the twin)
  and ``stress1m_4k.path`` without.

For each cell, ``bench_torch/run.run`` renders the configuration through
the port's ``Renderer`` with the seeded scene and map and compares one
frame with the plain reference (bench_torch/reference.py): a sound run is
correct; the control (the reference in bfloat16 in the program's place)
and colours 1 % off where the integrator produces them are not. Config
#5's altered frame runs under ``path``: the harness's compare and the 8
slabs' frame cut are those of ``nee``, and ``path`` spares the any-hit
twin's minutes.
"""

import argparse
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import calibrate  # noqa: E402
import compare  # noqa: E402
import run  # noqa: E402

SMALL = (32, 16)  # 8 slabs of 2 rows where the cell cuts its frame
SEED = 2**31 + 1013


def _altered(fn):
    """The integrator's colours 1 % off."""
    def integrate(*a, **k):
        res = fn(*a, **k)
        return res._replace(color=res.color * 1.01)
    return integrate


@pytest.mark.parametrize("cell, case", [
    ("stress44k_1080p.envis", "sound"), ("stress44k_1080p.envis", "control"),
    ("stress44k_1080p.envis", "altered"), ("stress1m_4k.nee", "sound"),
    ("stress1m_4k.nee", "control"), ("stress1m_4k.path", "altered"),
])
def test_the_cell_is_correct_and_its_faults_are_not(cell, case,
                                                    monkeypatch):
    spec = run.cell_spec(cell)
    limits = spec["limits"]["limits"]
    if case == "control":
        numbers = calibrate.control(spec, SEED, "cpu", SMALL)
        assert not compare.verdict(numbers, limits), numbers
        return
    if case == "altered":
        import webgpu_raytracing_tpu_torch.renderer as rmod

        for name in run.INTEGRATORS:
            monkeypatch.setattr(rmod, name, _altered(getattr(rmod, name)))
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=0.5,
                              trace=0)
    res = run.run(args, "cpu", spec, size=SMALL, out=lambda s: None)
    assert res["correct"] == (case == "sound"), res["compared"]
    assert res["attempted"] >= 1
    assert res["metrics"]["mrays_per_s"]["value"] > 0
