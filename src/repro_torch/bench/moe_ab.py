"""Row 11 (the dequant-fused MoE FFN, int8 and int4, capacities 128 and 8)
and row 9 (the bf16 MoE FFN, as a control) of this checkout against
another checkout's, on the card, in turns on the same inputs: the other,
this, this, the other, each in a process of its own that builds its own
tree's libraries.  With ``--cuts-this`` this checkout's row 11 is timed
again once for each part in `CUTS_THIS` cut out of (or changed in) its
source, each in a process of its own.

  python -m repro_torch.bench.moe_ab --other DIR [--cuts-this]

``DIR`` is a checkout (say an unpacked ``git archive`` of the parent commit
under ``build/``).  Shapes are `chip_smoke.py`'s kernels phase:
qwen2-moe-a2.7b's experts (60 routed of 64, top-4, d 2048, F 1408), random
tokens dispatched by the MoE layer's rule (t = C tokens at capacity C),
weights drawn from seed 0 and quantized per channel (int8) or in groups of
32 rows (int4); label base.  A row is ``<tree> <kernel>,ms,host_us``: the
median device time of one call with L2 flushed (`common.time_ms`) and the
host time of one call's enqueue.  A cut-out's output is wrong by design:
only its time is read.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SOURCE = "quant_moe_ffn.cu"
# every product (an empty asm keeps its operands live)
PRODUCTS = ("    wgmma_rs<AN, 0>(d[q], a, b, keep);",
            "(uint64_t)((steps * CHUNK) >> 4), 1);",
            '    asm volatile("" : "+f"(d[q][0]) : "r"(a[0]), "l"(b), '
            '"r"(keep));')
# the widening: the raw packed words go to the products
WIDENING = ("    if (BITS == 8) {\n      widen_i8(wr[2 * ks], a[ks][0], "
            "a[ks][1]);",
            "widen_i4(wr[ks], a[ks]);\n    }",
            "    for (int x = 0; x < 4; ++x) a[ks][x] = wr[ks];")
# (name, [(first text, last text[, replacement])]): each span of this
# checkout's row 11 source, both ends included, is cut out (or replaced)
CUTS_THIS = {
    # the weight stream, the widening and the folds stay
    "products": [PRODUCTS],
    "widening": [WIDENING],
    # both: what is left is the ring, the copies and the epilogues
    "products and widening": [PRODUCTS, WIDENING],
    # int4: two group accumulators, each group folded one group behind
    # after `wait_group 1` (the fold overlapping the next group's
    # products); ptxas then serialises every wgmma of the kernel
    "fold one group behind after wait_group 1": [
        ("  constexpr int P = GS == 0 ? 2 : (SET < PMAX ? SET : PMAX);",
         "  constexpr int P = GS == 0 ? 2 : (SET < PMAX ? SET : PMAX);",
         "  constexpr int P = 2;"),
        ("      if (gend)                      // the group's scales",
         "        if (!hend) wg_fence();       // the fold read what wgmma "
         "rewrites\n      }",
         """      if (gend) {
        wg_commit();
        wg_wait<1>();
        hold_all(S, true);
        fold_group(S, 1 - gj, S.fs[0]);
        if (S.rel >= 0 && me.lane == 0) bar_arrive(L.empty + 8 * S.rel);
        S.rel = LAST && hend ? st : -1;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\\n"
                     : "=f"(S.fs[0].x), "=f"(S.fs[0].y)
                     : "r"(ss + (qs / GS) * G::SRB));
        S.fsel = gj;
        S.fpend = true;
        hold_all(S, true);
        if (!hend) wg_fence();
      }""")],
    # pass B: its launch returns at once (pass A alone, and the memset)
    "pass B": [("  auto kern = qmoe_kernel<PASS, BITS, GS>;",
                "  auto kern = qmoe_kernel<PASS, BITS, GS>;",
                "  if (PASS == 1) return 0;\n"
                "  auto kern = qmoe_kernel<PASS, BITS, GS>;")],
}
MOE = dict(e=64, n_routed=60, top_k=4, d=2048, f=1408)
CAPS = (128, 8)


def cut(src: str, spans) -> str:
    """``src`` with each (first, last[, replacement]) span replaced (by
    nothing, by default); raises if a span is not found."""
    for first, last, *repl in spans:
        i = src.index(first)
        j = src.index(last, i) + len(last)
        src = src[:i] + "".join(repl) + src[j:]
    return src


def child(root: Path, csrc: Path | None, build: Path | None,
          only_q: bool) -> None:
    """Time ``root``'s wrappers (its kernels built from ``csrc``, into
    ``build``, where given) and print one JSON line."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.bench.common import time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_ffn as moe
    from repro_torch.quant import quantize
    if csrc is not None:
        _build.CSRC, _build.BUILD_DIR = csrc, build
    gen = torch.Generator(device="cuda").manual_seed(0)
    e, d, f = MOE["e"], MOE["d"], MOE["f"]

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                ).bfloat16()

    w1, w3 = normal((e, d, f), d ** -0.5), normal((e, d, f), d ** -0.5)
    w2 = normal((e, f, d), f ** -0.5)

    def dispatch(cap):
        # the MoE layer's rule (`layers.moe`) on cap random tokens
        xt = torch.randn(cap, d, generator=gen, device="cuda").bfloat16()
        logits = torch.randn(cap, e, generator=gen, device="cuda") * 2.0
        logits[:, MOE["n_routed"]:] = -1e30
        w, idx = torch.topk(torch.softmax(logits, -1), MOE["top_k"], dim=-1)
        w = w / (w.sum(-1, keepdim=True) + 1e-9)
        tokw = torch.einsum("tke,tk->et",
                            torch.nn.functional.one_hot(idx, e).float(), w)
        topw, topi = torch.topk(tokw, cap, dim=-1)
        live = topw > 0
        xe = xt[topi.reshape(-1)].reshape(e, cap, d) * live[..., None]
        return xe.bfloat16().contiguous(), (topw * live).contiguous()

    calls = {}
    for cap in CAPS:
        xe, comb = dispatch(cap)
        for bits in (8, 4):
            qs = [quantize(w, f"int{bits}") for w in (w1, w3, w2)]
            calls[f"row 11 int{bits} C{cap}"] = (
                lambda xe=xe, qs=qs, comb=comb: moe.quant_moe_ffn(
                    xe, *qs, comb))
        if not only_q:
            calls[f"row 9 bf16 C{cap}"] = (
                lambda xe=xe, comb=comb: moe.moe_ffn(xe, w1, w3, w2, comb))
    out = {}
    for name, fn in calls.items():
        ms = time_ms(fn)
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out[name] = (ms, us)
    print(json.dumps(out), flush=True)


def run(root: Path, csrc: Path | None = None, build: Path | None = None,
        only_q: bool = False):
    cmd = [sys.executable, __file__, "--child", str(root)]
    if csrc is not None:
        cmd += ["--csrc", str(csrc), "--build", str(build)]
    if only_q:
        cmd += ["--only-q"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{res.stdout}"
                         f"\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--cuts-this", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--csrc", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--only-q", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child.resolve(), args.csrc, args.build,
                     args.only_q)
    if args.other is None:
        ap.error("--other DIR is required")
    here = Path(__file__).resolve().parents[3]
    other = args.other.resolve()
    print("# moe_ab: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() + ": name,ms,host_us", flush=True)
    turns = [("other", other), ("this", here), ("this", here),
             ("other", other)]
    for tag, root in turns:
        for name, (ms, us) in run(root).items():
            print(f"{tag} {name},{ms:.4f},{us:.1f}", flush=True)
    if not args.cuts_this:
        return
    src = (here / "src/repro_torch/kernels/csrc" / SOURCE).read_text()
    for name, spans in CUTS_THIS.items():
        with tempfile.TemporaryDirectory() as tmp:
            csrc = Path(tmp) / "csrc"
            shutil.copytree(here / "src/repro_torch/kernels/csrc", csrc)
            (csrc / SOURCE).write_text(cut(src, spans))
            for kname, (ms, us) in run(here, csrc, Path(tmp) / "build",
                                       only_q=True).items():
                print(f"this without {name} {kname},{ms:.4f},{us:.1f}",
                      flush=True)


if __name__ == "__main__":
    main()
