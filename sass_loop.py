"""Instruction counts of a kernel's main loop, read from its SASS: a
development tool for the port's hand-written kernels, not part of the
package and not run by ``chip_smoke.py``.

  python3 sass_loop.py [--source FILE.cu] [--voxels N]

Compiles the source (default ``rcu_tpu_torch/csrc/evalstats.cu``) for
``sm_90a`` into a cubin, disassembles it with ``cuobjdump -sass`` (beside
``nvcc``), finds the loops and prints the largest one of each kernel: its
static instruction count, that count per 32 voxels when one pass handles
``--voxels`` voxels a thread (default: the wrapper's chunk; a warp
instruction stands for 32 lanes' work), and its most frequent opcodes.
A loop is the natural loop of a branch back to an earlier address: every
instruction from which the branch is reached without passing the loop's
head, wherever the compiler placed it. A branch back whose target does
not dominate it (cold code placed after the exit that jumps back into the
main line) is no loop: walking back from it reaches the function's entry.
Needs the CUDA toolkit, not a card.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import tempfile

from rcu_tpu_torch.ops.cuda import build, evalstats

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(0x[0-9a-f]+)|\(?(\.L_x_\d+)\)?")


def disassemble(source: str) -> str:
    """``cuobjdump -sass`` of ``source`` compiled as the build compiles it."""
    nvcc = build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernel.cubin")
        done = subprocess.run([nvcc, "-cubin", *flags, "-o", cubin, source],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{done.stderr}")
        return subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def parse(sass: str) -> dict:
    """-> {function: [(address, opcode, operands, predicated)]}."""
    functions, current, labels = {}, None, {}
    pending = []
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            address = int(m.group(1), 16)
            for label in pending:
                labels[label] = address
            pending = []
            current.append((address, m.group(3), m.group(4).strip(),
                            m.group(2) is not None))
    # branch targets given as labels become addresses
    for instrs in functions.values():
        for i, (address, op, args, predicated) in enumerate(instrs):
            if op.startswith("BRA"):
                t = _TARGET.search(args)
                if t and t.group(2) in labels:
                    instrs[i] = (address, op, hex(labels[t.group(2)]), predicated)
    return functions


def _target(op, args):
    if not op.startswith("BRA"):
        return None
    t = _TARGET.search(args)
    return int(t.group(1), 16) if t and t.group(1) else None


def largest_loop(instrs):
    """The instructions of the largest natural loop, in address order, or
    []."""
    index = {x[0]: i for i, x in enumerate(instrs)}
    preds = [[] for _ in instrs]
    for i, (address, op, args, predicated) in enumerate(instrs):
        target = _target(op, args)
        if target in index:
            preds[index[target]].append(i)
        ends = op.split(".")[0] in ("BRA", "EXIT", "RET") and not predicated
        if not ends and i + 1 < len(instrs):
            preds[i + 1].append(i)
    best = set()
    for i, (address, op, args, _) in enumerate(instrs):
        target = _target(op, args)
        if target is None or target > address or target not in index:
            continue
        head = index[target]
        body, stack = {head, i}, [i] if i != head else []
        while stack:  # backwards from the branch, stopping at the head
            for p in preds[stack.pop()]:
                if p not in body:
                    body.add(p)
                    stack.append(p)
        if 0 in body and head != 0:
            continue  # the entry reaches the branch around the head
        if len(body) > len(best):
            best = body
    return [instrs[i] for i in sorted(best)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", default=os.path.join(build.SRC_DIR,
                                                         "evalstats.cu"))
    parser.add_argument("--voxels", type=int,
                        default=evalstats.VOXELS_PER_THREAD,
                        help="voxels a thread handles per loop pass")
    args = parser.parse_args(argv)
    for name, instrs in parse(disassemble(args.source)).items():
        loop = largest_loop(instrs)
        if not loop:
            continue
        ops = collections.Counter(x[1].split(".")[0] for x in loop)
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(12))
        print(f"{name}: {len(instrs)} instructions; largest loop "
              f"{len(loop)} instructions for {args.voxels} voxels a thread = "
              f"{len(loop) / args.voxels:.1f} warp instructions per 32 voxels; "
              f"{top}")


if __name__ == "__main__":
    main()
