"""Rows 14 (embed gather) and 16 (the paper's indirect gather) of this
checkout against another checkout's, on the card, in turns on the same
inputs: the other, this, this, the other, each in a process of its own
that builds its own tree's library.

  python -m repro_torch.bench.gather_ab --other DIR [--tables-probe]
      [--cuts-this] [--device cpu]

``DIR`` is a checkout (say an unpacked ``git archive`` of the parent commit
under ``build/``).  Row 14 runs at the tuner's qwen3-0.6b spec (N 8192 ids
into the padded vocab 152064, d 1024), float32 and bf16 tables, every
label of `EMBED_LABELS`, beside ``F.embedding`` on the float32 table.  Row
16 runs at `chip_smoke.py`'s cells (N 2^26, 8 tables, AI 6, block 1024):
tables of 2^14 at locality 4096 and of 2^24 read fully at random, labels
`ROW16_LABELS`.  A row is ``<tree> <kernel>,ms``: the median device time
of one call with L2 flushed (`common.time_ms`).

``--tables-probe`` first times the other checkout's row 16 at locality
4096 with 1, 2, 4 and 8 tables (does the time scale with the lookups?).
``--cuts-this`` times copies of this checkout's kernels with one part cut
or one size changed (`CUTS_THIS`: row 16's window path, so every piece
reads the tables directly; its reuse of a staged span across programs;
its staging copies, its lookups, its chain, whose outputs are then wrong
and only their time is read; its window at 192 KB and at 32 KB, which
moves the L1 left beside it; row 14's bulk-copy path for float32 rows).
``--device cpu`` lists the plans only: row 14's split of each label at 132
SMs and row 16's walk (persistent grid, piece, batch, window) with the
share of pieces each label stages at the locality cell, from
`gather_stream.walk` at N 2^20.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

EMBED_LABELS = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")
EMBED_SPEC = (8192, 152064, 1024)      # qwen3-0.6b, 8 slots x 1024
ROW16_LABELS = ("base", "con4", "gap4", "simd4")
ROW16_CELLS = {"loc4096": (1 << 14, 4096), "random": (1 << 24, 1 << 24)}
N16, AI, BLOCK16 = 1 << 26, 6, 1024
PROBE_TABLES = (1, 2, 4, 8)
SEED = 11

# name -> (source, timed rows, [(text, replacement)], row 16's window
# budget in bytes or None): each text of this checkout's source is replaced
# once (raises if a text is not found); a budget replaces the kernel's and
# the wrapper's `WINDOW_BYTES`
CUTS_THIS = {
    "no window path (every piece direct)": (
        "stream.cu", "row16", [("constexpr bool USE_WINDOW = true;",
                                "constexpr bool USE_WINDOW = false;")], None),
    "no reuse across programs": (
        "stream.cu", "row16", [("constexpr bool REUSE = true;",
                                "constexpr bool REUSE = false;")], None),
    "no staging copies (a wrong window; time only)": (
        "stream.cu", "row16", [(
            "if (probe == 0) stage<NL>(tp, win, w.w, sh.base[j], "
            "sh.count[j]);", "")], None),
    "no lookups (no table read; time only)": (
        "stream.cu", "row16", [(
            "x[u * V + e][l] = smem ? win[l * w.w + (id - a)]\n"
            "                                         : __ldg(tp.p[l] + id);",
            "x[u * V + e][l] = __int_as_float(id + l);")], None),
    "no chain (the values summed; time only)": (
        "stream.cu", "row16", [(
            "if (probe == 0) chains<NL, EU * V>(x, n_arith, o);",
            "for (int q = 0; q < EU * V; ++q) { o[q] = 0.f; for (int l = 0; "
            "l < NL; ++l) o[q] += x[q][l]; }")], None),
    "a 192 KB window (28 KB of L1 beside it)": (
        "stream.cu", "row16", [], 196608),
    "a 32 KB window (no 4096-run fits; 156 KB of L1)": (
        "stream.cu", "row16", [], 32768),
    "no bulk path (float32 rows by lanes)": (
        "embed_gather.cu", "row14", [("BULK_BYTES = 64 * 1024;",
                                      "BULK_BYTES = 0;")], None),
}


def cut(src: str, edits) -> str:
    for text, repl in edits:
        if text not in src:
            raise SystemExit(f"cut text not found: {text!r}")
        src = src.replace(text, repl, 1)
    return src


def child(root: Path, mode: str, csrc: Path | None, build: Path | None,
          window_bytes: int | None) -> None:
    """Time ``root``'s wrappers (its kernels built from ``csrc`` into
    ``build``, where given) and print one JSON line {name: ms}."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.bench import fig11_ai as fig11
    from repro_torch.bench.common import time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import embed_gather as eg
    from repro_torch.kernels import gather_stream as gs
    if csrc is not None:
        _build.CSRC, _build.BUILD_DIR = csrc, build
    if window_bytes is not None:
        gs.WINDOW_BYTES = window_bytes
    if mode.startswith("build:"):
        _build.build((mode[len("build:"):],))
        return
    out = {}
    if mode in ("ab", "row14"):
        n, vocab, d = EMBED_SPEC
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        ids = torch.randint(0, vocab, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        table = torch.randn((vocab, d), generator=gen, device="cuda")
        for tab in (table, table.bfloat16()):
            tag = "f32" if tab.dtype == torch.float32 else "bf16"
            for lab in EMBED_LABELS:
                out[f"row14 {tag} {lab}"] = time_ms(
                    lambda: eg.embed_gather(ids, tab, lab))
        out["F.embedding f32"] = time_ms(
            lambda: torch.nn.functional.embedding(ids, table))
        del table
    if mode == "row14":
        print(json.dumps(out), flush=True)
        return
    cells = dict(ROW16_CELLS) if mode != "tables" else {
        "loc4096": ROW16_CELLS["loc4096"]}
    for cell, (tlen, window) in cells.items():
        idx, tables = fig11.gather_inputs(N16, tlen, window, "cuda",
                                          seed=SEED)
        if mode == "tables":
            for nt in PROBE_TABLES:
                out[f"row16 {cell} base {nt} tables"] = time_ms(
                    lambda: gs.gather_stream(idx, tables[:nt], "base",
                                             ai=AI, block=BLOCK16))
            continue
        for lab in ROW16_LABELS:
            out[f"row16 {cell} {lab}"] = time_ms(
                lambda: gs.gather_stream(idx, tables, lab, ai=AI,
                                         block=BLOCK16))
        del idx, tables
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def run(root: Path, mode: str, csrc: Path | None = None,
        build: Path | None = None, window_bytes: int | None = None) -> dict:
    cmd = [sys.executable, __file__, "--child", str(root), "--mode", mode]
    if csrc is not None:
        cmd += ["--csrc", str(csrc), "--build", str(build)]
    if window_bytes is not None:
        cmd += ["--window-bytes", str(window_bytes)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{res.stdout}"
                         f"\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def list_plans() -> None:
    """The plans of this checkout, on the CPU: nothing is timed."""
    import torch
    from repro_torch.bench.common import labels
    from repro_torch.core.coarsening import CoarseningConfig
    from repro_torch.kernels import embed_gather as eg
    from repro_torch.kernels import gather_stream as gs
    n, _, _ = EMBED_SPEC
    print("# row 14 at N 8192, 132 SMs: label,programs,blocks_a_program,"
          "rows_a_block,grid")
    for lab in EMBED_LABELS:
        sp = eg.split_plan(n, CoarseningConfig.parse(lab), sms=132)
        print(f"row14,{lab},{sp.programs},{sp.per_program},{sp.rows},"
              f"{sp.grid}")
    n_cpu = 1 << 20
    idx = torch.as_tensor(gs.make_indices(n_cpu, 1 << 14, 4096, seed=SEED))
    print(f"# row 16 at N 2^20, 8 tables of 2^14, locality 4096, 132 SMs: "
          f"label,blocks,piece,batch,window,staged_share")
    for lab in labels():
        w = gs.walk(idx, 8, 1 << 14, CoarseningConfig.parse(lab),
                    block=BLOCK16, sms=132)
        print(f"row16,{lab},{w.blocks},{w.piece},{w.batch},{w.window},"
              f"{float(w.staged.float().mean()):.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--tables-probe", action="store_true")
    ap.add_argument("--cuts-this", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="ab", help=argparse.SUPPRESS)
    ap.add_argument("--csrc", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--window-bytes", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child.resolve(), args.mode, args.csrc, args.build,
                     args.window_bytes)
    if args.device == "cpu":
        return list_plans()
    if args.other is None:
        ap.error("--other DIR is required on the card")
    here = Path(__file__).resolve().parents[3]
    other = args.other.resolve()
    print("# gather_ab: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() + ": name,ms", flush=True)
    if args.tables_probe:
        for name, ms in run(other, "tables").items():
            print(f"other {name},{ms:.4f}", flush=True)
    for tag, root in [("other", other), ("this", here), ("this", here),
                      ("other", other)]:
        for name, ms in run(root, "ab").items():
            print(f"{tag} {name},{ms:.4f}", flush=True)
    if not args.cuts_this:
        return
    with tempfile.TemporaryDirectory() as tmp:
        cuts = []               # every cut's copy, all built at once first
        for i, (name, (source, mode, edits, budget)) in enumerate(
                CUTS_THIS.items()):
            src = (here / "src/repro_torch/kernels/csrc" / source).read_text()
            if budget is not None:
                edits = edits + [("constexpr int WINDOW_BYTES = 139264;",
                                  f"constexpr int WINDOW_BYTES = {budget};")]
            csrc, build = Path(tmp) / f"cut{i}" / "csrc", Path(tmp) / f"cut{i}"
            shutil.copytree(here / "src/repro_torch/kernels/csrc", csrc)
            (csrc / source).write_text(cut(src, edits))
            cmd = [sys.executable, __file__, "--child", str(here), "--mode",
                   "build:" + source.removesuffix(".cu"), "--csrc", str(csrc),
                   "--build", str(build)]
            cuts.append((name, mode, csrc, build, budget,
                         subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
        for name, *_, proc in cuts:
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"building the cut {name!r} failed:\n{log}")
        for name, mode, csrc, build, budget, _ in cuts:
            for kname, ms in run(here, mode, csrc, build, budget).items():
                print(f"this with {name} {kname},{ms:.4f}", flush=True)


if __name__ == "__main__":
    main()
