"""Whether this tree's kernels compile as another tree's do.

Builds the named sources of ``ldpc_tpu_torch/ops/csrc/`` from this tree and
from ``--other`` (the root of another checkout, for example an unpacked
``git archive`` of the parent commit) with the same nvcc flags, and for
every kernel of the other tree reports whether this tree's kernel has the
same registers and spills (``-Xptxas -v``) and the same SASS instructions
(``cuobjdump -sass``, addresses and encodings dropped).  Kernels are matched
by name with the anonymous namespace's hash removed (it follows the file's
path); this tree's retiring kernels instantiated on the 32-bit state word
(template argument ``unsigned``, mangled ``j``) and its trained min-sum
kernels (``neural_group_kernel``, ``neural_group_slice_kernel``) on that
word are matched to kernels with no such argument, and those on the 64-bit
word (``y``) and on the 128-bit word (the struct ``Word128``) that the other
tree lacks are listed apart.

Run:  python -m ldpc_tpu_torch.tools.probe_sass_diff --other <checkout>
      [--stems fused_retire fused_neural]

Needs nvcc and cuobjdump (no card).  Prints one JSON object; ``main(argv)``
returns it.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ldpc_tpu_torch.ops import _build

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
# A kernel whose last template argument is the state word (the retiring
# kernels' <TRACK, POW2, Word>, neural_group's <POW2, L, STAGED, Word>), on
# the 32-bit word, matched to the other tree's kernel without it.
_NARROW_WORD = re.compile(r"(I(?:L[a-z]+n?\d+E)+)jE")
_WIDE_WORD = re.compile(r"I(?:L[a-z]+n?\d+E)+(yE|\w*Word128E)")


def _key(name: str) -> str:
    return _NARROW_WORD.sub(r"\1E", _ANON.sub("anon", name))


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            out[name] = {"spill_bytes": [int(w) for w in line.replace(",", "").split()
                                         if w.isdigit()][1:3]}
        elif name and "registers" in line and "Used" in line:
            out[name]["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def _sass(lib: Path) -> dict:
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                funcs[name].append(_ANON.sub("anon", m.group(1)))
    return funcs


def _build_other(csrc: Path, stem: str, out_dir: Path) -> tuple[Path, str]:
    lib = out_dir / f"lib{stem}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS.get(stem, ()), "-o",
           str(lib), str(csrc / f"{stem}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the other tree's {stem}.cu:\n{proc.stdout}")
    return lib, proc.stdout


def compare(lib: Path, log: str, other_lib: Path, other_log: str) -> dict:
    """Per kernel of the other tree: same registers and spills, same SASS."""
    ptx = {_key(k): v for k, v in _ptxas(log).items()}
    other_ptx = {_key(k): v for k, v in _ptxas(other_log).items()}
    sass = {_key(k): v for k, v in _sass(lib).items()}
    other_sass = {_key(k): v for k, v in _sass(other_lib).items()}
    kernels = {}
    for key, theirs in other_ptx.items():
        ours, a, b = ptx.get(key), sass.get(key, []), other_sass.get(key, [])
        kernels[key] = {"ptxas": theirs, "same_ptxas": ours == theirs,
                        "same_sass": key in sass and a == b, "sass_lines": [len(a), len(b)]}
        if a != b:  # the first instructions that differ, this tree's then the other's
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            kernels[key]["first_difference"] = [i, a[i:i + 3], b[i:i + 3]]
            kernels[key]["lines_differing"] = sum(x != y for x, y in zip(a, b))
    wide = {k: v for k, v in ptx.items() if _WIDE_WORD.search(k) and k not in other_ptx}
    return {"kernels": len(kernels),
            "same_ptxas": sum(v["same_ptxas"] for v in kernels.values()),
            "same_sass": sum(v["same_sass"] for v in kernels.values()),
            "differ": {k: v for k, v in kernels.items()
                       if not (v["same_ptxas"] and v["same_sass"])},
            "only_here": sorted(k for k in ptx if k not in other_ptx and k not in wide),
            "wide_word_ptxas": wide}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--stems", nargs="+", default=["fused_retire", "fused_neural"])
    args = parser.parse_args(argv)
    csrc = args.other / "ldpc_tpu_torch" / "ops" / "csrc"
    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(2 * len(args.stems)) as pool:
        ours = {s: pool.submit(_build.build, s) for s in args.stems}
        theirs = {s: pool.submit(_build_other, csrc, s, out_dir) for s in args.stems}
        result = {}
        for s in args.stems:
            other_lib, other_log = theirs[s].result()
            result[s] = compare(ours[s].result(), _build.build_log(s), other_lib, other_log)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
