"""Whether an edit of the kernel sources moved the code a kernel compiles
to: the SASS and the `ptxas -v` resources of every kernel of two trees,
function by function.

    python -m nanosnp_tpu_torch.ops.sass_compare PARENT [--out DIR]

On a machine with the CUDA toolkit (nvcc, cuobjdump, cu++filt). PARENT is
another checkout of the repo (a `git archive` of the parent commit, say).
Each `csrc/*.cu` of both trees is compiled to a cubin with the flags of
`ops/build.py` (one nvcc each, started together, into DIR, by default
`ops/build/sass/`), disassembled with `cuobjdump -sass` (kept beside the
cubin as `.sass`), and split into functions. A kernel of this tree is
paired with the parent's kernel of the same demangled name in the same
source, or else with one whose SASS is the same, or else with the one of
the same name up to its template arguments.
For each it prints the registers and spills of both, whether the SASS is
the same (instruction words and addresses, the encoding comments
dropped), and any kernel of this tree, in any source, with the very same
SASS. Prints one `{"sass_compare": [...]}` line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

from . import build

_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for)"
                    r" '?([\w$]+)'?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_HEX = re.compile(r"/\* 0x[0-9a-f]+ \*/")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled name: {"registers", "spill_stores", "spill_loads"}} from
    the `-Xptxas -v` report of one compilation."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def parse_sass(text: str) -> Dict[str, List[str]]:
    """{mangled name: its instructions} from `cuobjdump -sass` of one
    cubin, each line stripped of its encoding comments and spaces."""
    out: Dict[str, List[str]] = {}
    body: Optional[List[str]] = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            body = out.setdefault(m.group(1), [])
            continue
        if body is None:
            continue
        line = " ".join(_HEX.sub("", line).split())
        if line:
            body.append(line)
    return out


def _base(demangled: str) -> str:
    """A demangled kernel's name without its namespace, template arguments
    and parameters."""
    name = re.sub(r"<unnamed>::|\(anonymous namespace\)::", "", demangled)
    return re.split(r"[<(]", name, maxsplit=1)[0].split()[-1]


def pair(parent: Dict[str, List[str]], change: Dict[str, List[str]],
         names: Dict[str, str]) -> Dict[str, Optional[str]]:
    """{change kernel: its parent kernel or None}: the same demangled name
    (`names`; nvcc mangles an anonymous namespace by its file, so the
    mangled names of two trees differ), else unpaired parent SASS that is
    the same, else the one unpaired parent kernel of the same base name."""
    def name(f):
        return names.get(f, f)

    out: Dict[str, Optional[str]] = dict.fromkeys(change)
    free = list(parent)
    # each pass over every kernel still unpaired; by base name only where
    # one candidate is left
    for match, unique in ((lambda p, c: name(p) == name(c), False),
                          (lambda p, c: parent[p] == change[c], False),
                          (lambda p, c: _base(name(p)) == _base(name(c)),
                           True)):
        for c in [c for c in change if out[c] is None]:
            found = [p for p in free if match(p, c)]
            if found and (len(found) == 1 or not unique):
                out[c] = found[0]
                free.remove(found[0])
    return out


def _tools():
    bin_dir = Path(build.nvcc_path()).parent
    return (str(bin_dir / "cuobjdump"), str(bin_dir / "cu++filt"))


def _compile(trees: Dict[str, Path], out_dir: Path):
    """{tree: {stem: (ptxas report, SASS text)}}, one nvcc a source."""
    procs = {}
    for tree, root in trees.items():
        csrc = root / "nanosnp_tpu_torch" / "ops" / "csrc"
        (out_dir / tree).mkdir(parents=True, exist_ok=True)
        for src in sorted(csrc.glob("*.cu")):
            flags = [f for f in build.NVCC_FLAGS
                     if f not in ("-shared", "-Xcompiler", "-fPIC")]
            cubin = out_dir / tree / f"{src.stem}.cubin"
            procs[tree, src.stem] = (cubin, subprocess.Popen(
                [build.nvcc_path(), "-cubin", *flags, "-I", str(csrc), "-o",
                 str(cubin), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    cuobjdump, _ = _tools()
    got: Dict[str, Dict[str, tuple]] = {tree: {} for tree in trees}
    for (tree, stem), (cubin, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tree} {stem}:\n"
                               f"{log[-3000:]}")
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        cubin.with_suffix(".sass").write_text(sass)
        got[tree][stem] = (log, sass)
    return got


def _demangle(names) -> Dict[str, str]:
    names = sorted(set(names))
    _, cufilt = _tools()
    text = subprocess.run([cufilt], input="\n".join(names), check=True,
                          capture_output=True, text=True).stdout
    return dict(zip(names, text.splitlines()))


def compare(parent: Path, change: Path, out_dir: Path) -> List[dict]:
    built = _compile({"parent": parent, "change": change}, out_dir)
    sass = {t: {s: parse_sass(v[1]) for s, v in built[t].items()}
            for t in built}
    res = {t: {s: parse_ptxas(v[0]) for s, v in built[t].items()}
           for t in built}
    names = _demangle(n for t in sass for s in sass[t] for n in sass[t][s])
    everywhere = [(s, n, body) for s, fns in sass["change"].items()
                  for n, body in fns.items()]
    rows = []
    for stem in sorted(set(sass["parent"]) | set(sass["change"])):
        p_fns = sass["parent"].get(stem, {})
        c_fns = sass["change"].get(stem, {})
        pairs = pair(p_fns, c_fns, names)
        for c, p in pairs.items():
            rows.append(dict(
                source=f"{stem}.cu", kernel=names.get(c, c),
                parent_kernel=names.get(p, p) if p else None,
                same_sass=p is not None and p_fns[p] == c_fns[c],
                instructions=len(c_fns[c]),
                resources=res["change"][stem].get(c),
                parent_resources=res["parent"][stem].get(p) if p else None,
                same_sass_in_change=[names.get(n, n) for s, n, body
                                     in everywhere
                                     if body == c_fns[c] and n != c]))
        for p in sorted(set(p_fns) - {v for v in pairs.values() if v}):
            rows.append(dict(source=f"{stem}.cu", kernel=None,
                             parent_kernel=names.get(p, p), same_sass=False,
                             parent_resources=res["parent"][stem].get(p)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--out", default=str(build.BUILD_DIR / "sass"))
    args = ap.parse_args(argv)
    change = Path(__file__).resolve().parents[2]
    rows = compare(Path(args.parent).resolve(), change, Path(args.out))
    for r in rows:
        res, pres = r.get("resources") or {}, r.get("parent_resources") or {}
        print(f"{r['source']:18s} same SASS {str(r['same_sass']):5s} "
              f"regs {pres.get('registers')} -> {res.get('registers')}, "
              f"spills {pres.get('spill_stores')}/{pres.get('spill_loads')}"
              f" -> {res.get('spill_stores')}/{res.get('spill_loads')}: "
              f"{r['kernel']} (parent: {r['parent_kernel']})"
              + (f"; the same SASS as {r['same_sass_in_change']}"
                 if r.get("same_sass_in_change") else ""), flush=True)
    print(json.dumps({"sass_compare": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
