"""Registers, spills and SASS of the cluster trace kernels, as compiled.

    python3 tools/torch_sass.py [--nvcc-flag F] [--sass NAME] [--out DIR]
    python3 tools/torch_sass.py --blocks FILE [--lo ADDR] [--hi ADDR]

Compiles ``csrc/*.cu`` with the package's flags (``ops/_build.py``
``NVCC_FLAGS``, plus each ``--nvcc-flag``) and ``-Xptxas -v`` into a
library of its own under ``build/sass/``, and prints, for every kernel
(name demangled with ``cu++filt``), the registers, the static shared
memory and the spill bytes that ``ptxas`` reports. For each kernel whose
demangled name matches a ``--sass`` regular expression (repeatable;
default: the any-hit and pairs entries of K2n and of K3 with its own
order, and K2p), writes its ``cuobjdump -sass`` to ``DIR`` (default
``chiprun_out/sass/``), one file per kernel, and prints its instruction
count by opcode. Fails without ``nvcc``.

``--blocks FILE`` reads such a file (no ``nvcc`` needed) and prints its
basic blocks between the hex addresses ``--lo`` and ``--hi``: start, number
of instructions, f32 ones, loads, and the branch that ends the block. The
instructions a slot test takes on each of its paths are the sums of the
blocks along the path (K2p's slot loop: from the load of the slot's face id
to the loop's back branch).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_SASS = (
    r"trace_near_kernel(_min)?<.*Exact<\(bool\)1>>",
    r"trace_near_kernel(_min)?<.*Pairs>",
    r"trace_two_level_kernel(_min)?<.*Exact<\(bool\)1>, \(bool\)1>",
    r"trace_two_level_kernel(_min)?<.*Pairs, \(bool\)1>",
    r"trace_kernel<.*Pairs>",
)


def _demangle(names, tool):
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _instructions(lines):
    """(address, opcode, text) of each SASS instruction of a dump."""
    out = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            text = m.group(2).strip()
            op = text.split()[1 if text.startswith("@") else 0]
            out.append((int(m.group(1), 16), op.split(".")[0], text))
    return out


def print_blocks(path: str, lo: int, hi: int) -> None:
    """The basic blocks of a dumped function between addresses lo and hi."""
    with open(path) as fh:
        ins = [x for x in _instructions(fh.read().splitlines())
               if lo <= x[0] <= hi]
    target = re.compile(r"BRA\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)")
    starts = {int(m.group(1), 16) for _, _, t in ins
              for m in [target.search(t)] if m}
    block = []
    for addr, op, text in ins:
        if block and addr in starts:
            _print_block(block)
            block = []
        block.append((addr, op, text))
        if op in ("BRA", "EXIT"):
            _print_block(block)
            block = []
    if block:
        _print_block(block)


def _print_block(block) -> None:
    f32 = sum(op in ("FMUL", "FADD", "FSETP", "FFMA", "FMNMX", "FSEL",
                     "MUFU", "FCHK") for _, op, _ in block)
    loads = sum(op.startswith("LD") for _, op, _ in block)
    last = block[-1][2] if block[-1][1] in ("BRA", "EXIT") else ""
    last = re.sub(r"\s+", " ", last)
    print(f"{block[0][0]:#07x} {len(block):4d} instructions, {f32:3d} f32, "
          f"{loads:2d} loads  {last}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nvcc-flag", action="append", default=[])
    ap.add_argument("--sass", action="append", default=None)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sass"))
    ap.add_argument("--blocks", default=None)
    ap.add_argument("--lo", default="0")
    ap.add_argument("--hi", default="ffffffff")
    a = ap.parse_args()
    if a.blocks:
        print_blocks(a.blocks, int(a.lo, 16), int(a.hi, 16))
        return 0

    from webgpu_raytracing_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    bindir = os.path.dirname(nvcc)
    filt = shutil.which("cu++filt") or os.path.join(bindir, "cu++filt")
    cuobjdump = shutil.which("cuobjdump") or os.path.join(bindir, "cuobjdump")
    lib_dir = os.path.join(ROOT, "build", "sass")
    os.makedirs(lib_dir, exist_ok=True)
    so = os.path.join(lib_dir, "libwrt_torch_sass.so")
    cmd = [nvcc, *_build.NVCC_FLAGS, *a.nvcc_flag, "-Xptxas", "-v", "-o", so,
           *_build._sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, file=sys.stderr)
        return 1
    kernels, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            kernels[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            kernels[name]["static_smem"] = int(m.group(1)) if m else 0
    names = _demangle(list(kernels), filt)
    flags = " ".join(a.nvcc_flag)
    for mangled, info in sorted(kernels.items(), key=lambda kv: names[kv[0]]):
        print(f"{names[mangled]}: {info.get('registers')} registers, "
              f"{info.get('static_smem')} bytes static shared, "
              f"{info.get('spill_bytes')} bytes spilled (flags: {flags})",
              flush=True)
    wanted = a.sass or list(DEFAULT_SASS)
    dump = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    os.makedirs(a.out, exist_ok=True)
    counts = {}
    for mangled, lines in funcs.items():
        pretty = names.get(mangled) or _demangle([mangled], filt)[mangled]
        if not any(re.search(w, pretty) for w in wanted):
            continue
        ops = collections.Counter(op for _, op, _ in _instructions(lines))
        fname = re.sub(r"[^A-Za-z0-9]+", "_", pretty)[:120] + ".sass"
        with open(os.path.join(a.out, fname), "w") as fh:
            fh.write(f"// {pretty}\n" + "\n".join(lines) + "\n")
        counts[pretty] = dict(total=sum(ops.values()),
                              **dict(ops.most_common()))
        print(f"{pretty}: {sum(ops.values())} SASS instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(16))
              + f" -> {os.path.relpath(os.path.join(a.out, fname), ROOT)}",
              flush=True)
    print(json.dumps({"flags": flags, "kernels": {
        names[k]: v for k, v in kernels.items()}, "sass_counts": counts}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
