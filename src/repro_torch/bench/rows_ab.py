"""Rows 3-4 (the contiguous decode and verify kernels) of this checkout
against another checkout's, on the card, in turns on the same inputs: the
other, this, this, the other, each in a process of its own that builds its
own tree's library.  With ``--cuts`` the other checkout's kernel is timed
again once for each part in `CUTS` cut out of its source (the design of
``csrc/decode_attention.cu`` before the rows kernel was rewritten: which
part holds its time); with ``--cuts-this`` this checkout's, for each part
in `CUTS_THIS`.

  python -m repro_torch.bench.rows_ab --other DIR [--cuts] [--cuts-this]

``DIR`` is a checkout (say an unpacked ``git archive`` of the parent commit
under ``build/``).  Shapes are `chip_smoke.py`'s kernels phase: qwen3-0.6b
(B 8, 16/8 heads, D 128), contiguous decode at S 1024 and bkv 128 with one
slot at S + 6, verify at T 5 through a 64-page table of 16-row pages;
label base.  A row is ``<tree> <kernel>,ms,host_us``: the median device
time of one call with L2 flushed (`common.time_ms`) and the host time of
one call's enqueue.  A cut-out's output is wrong by design: only its time
is read.
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

# (name, [(first text, last text)]): each span, both ends included, is cut
# out of the old `rows_partials_kernel` / `launch_rows`
CUTS = {
    "loads": [
        ("      for (int i = tid; i < n_vec; i += blockDim.x) {\n"
         "        const int r = i / vec_per_row, cc = i - r * vec_per_row;\n"
         "        const size_t off = ((rbase + r)",
         "            *reinterpret_cast<const uint4*>(v + off);\n      }\n"),
        ("      if (QUANT && tid < tr) {\n",
         "        vss[tid] = v_scale[so];\n      }\n")],
    "scores": [("      for (int idx = warp; idx < rr * tr; idx += nwarps) {",
                "          sc[r * tr + kr] = ok ? s * scale : NEG;\n"
                "        }\n      }\n")],
    "softmax": [("      if (tid < rr) {\n        const int r = tid;",
                 "        al[r] = alpha;\n      }\n")],
    "pv": [("      for (int kr = 0; kr < tr; ++kr) {\n"
            "        const float vv = kv_float(vs[kr * d + tid]);",
            "          if (r < rr) acc[r] += sc[r * tr + kr] * vv;\n"
            "      }\n")],
    "partials": [
        ("  for (int r = 0; r < MAXR; ++r) {\n    if (r >= rr) continue;\n",
         "    acc_out[o * d + tid] = acc[r];\n  }\n"),
        ("    for (int r = 0; r < rr; ++r) {\n"
         "      const size_t o = part0 + (size_t)r * n_splits;",
         "      acc_out[o * d + tid] = 0.f;\n    }\n")],
    "combine": [("  combine_kernel<<<b * hkv * rr, d, 0, st>>>(",
                 "      n_splits, d, t, g, hkv);\n")],
}
# the same for this checkout's `rows_kernel` (a third text, where given,
# takes the span's place)
CUTS_THIS = {
    "all but the live test": [
        ("  // the split's tiles in walk order",
         "  // the split's tiles in walk order",
         "  return;\n  // the split's tiles in walk order")],
    "loads": [("#pragma unroll\n    for (int r = l_r; r < TR; r += RSTEP) {",
               "      cp4(sc + TR + tid, a.v_scale + so, ok);\n    }\n")],
    "scores": [("    for (int k0 = 0; k0 < d; k0 += 16) {\n"
                "      uint32_t bf[NT][2];",
                "          mma16816(s[mt][nt], af, bf[nt][0], bf[nt][1]);\n"
                "      }\n    }\n")],
    "softmax": [("    // the online softmax in registers",
                 "    __syncwarp();\n")],
    "pv": [("    // O = O * alpha + P V in float32",
            "      acc[i][1] = o1;\n    }\n")],
    "partials": [("    if (t == run_o[jc + 1] - 1) {",
                  "        acc[i][0] = acc[i][1] = 0.f;\n      }\n    }\n")],
    "merge": [("  // The last block merges the live splits in split order",
               "  for (int r = tid; r < R; r += blockDim.x) mxs[r] = 0u;\n")],
}
KERNELS = ("contig bf16", "contig int8", "verify bf16", "verify int8")


def cut(src: str, spans) -> str:
    """``src`` with each (first, last[, replacement]) span replaced (by
    nothing, by default); raises if a span is not found."""
    for first, last, *repl in spans:
        i = src.index(first)
        j = src.index(last, i) + len(last)
        src = src[:i] + "".join(repl) + src[j:]
    return src


def child(root: Path, csrc: Path | None, build: Path | None) -> None:
    """Time ``root``'s wrappers (its kernel built from ``csrc``, into
    ``build``, where given) and print one JSON line."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.bench.common import time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.quant import quantize_kv
    if csrc is not None:
        _build.CSRC, _build.BUILD_DIR = csrc, build
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, hkv, d = 8, 16, 8, 128

    def kv(n, ps, dead, quant):
        k, v = (torch.randn(n, ps, hkv, d, generator=gen, device="cuda")
                for _ in range(2))
        if not quant:
            k, v = k.bfloat16(), v.bfloat16()
            k[dead], v[dead] = 1e4, 1e4
            return k, v, {}
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        k[dead], v[dead], ks[dead], vs[dead] = 127, 127, 1e4, 1e4
        return k, v, {"k_scale": ks, "v_scale": vs}

    calls = {}
    s = 1024
    q1 = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    pos = torch.randint(128, 576, (b,), generator=gen, device="cuda")
    pos[-1] = s + 6
    dead = torch.arange(s, device="cuda")[None, :] > pos[:, None]
    pos = pos.to(torch.int32)
    for quant in (False, True):
        k, v, sc = kv(b, s, dead, quant)
        calls[f"contig {'int8' if quant else 'bf16'}"] = (
            lambda k=k, v=v, sc=sc: dec.decode_attention(q1, k, v, pos,
                                                         bkv=128, **sc))
    ps, npp, t = 16, 64, 5
    n_pages = b * npp + 5
    qt = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * npp]
    bt = (perm + 1).reshape(b, npp).to(torch.int32)
    pos0 = torch.randint(128, 572, (b,), generator=gen, device="cuda")
    rows = torch.arange(npp * ps, device="cuda")
    deadp = torch.ones(n_pages, ps, dtype=torch.bool, device="cuda")
    deadp[bt.long()[:, rows // ps], (rows % ps).expand(b, -1)] = \
        rows[None, :] > (pos0 + t)[:, None]
    pos0 = pos0.to(torch.int32)
    for quant in (False, True):
        k, v, sc = kv(n_pages, ps, deadp, quant)
        calls[f"verify {'int8' if quant else 'bf16'}"] = (
            lambda k=k, v=v, sc=sc: dec.verify_attention(qt, k, v, bt, pos0,
                                                         **sc))
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


def run(root: Path, csrc: Path | None = None, build: Path | None = None):
    cmd = [sys.executable, __file__, "--child", str(root)]
    if csrc is not None:
        cmd += ["--csrc", str(csrc), "--build", str(build)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{res.stdout}"
                         f"\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--cuts-this", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--csrc", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child.resolve(), args.csrc, args.build)
    if args.other is None:
        ap.error("--other DIR is required")
    here = Path(__file__).resolve().parents[3]
    other = args.other.resolve()
    print("# rows_ab: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() + ": name,ms,host_us", flush=True)
    turns = [("other", other), ("this", here), ("this", here),
             ("other", other)]
    for tag, root in turns:
        for name, (ms, us) in run(root).items():
            print(f"{tag} {name},{ms:.4f},{us:.1f}", flush=True)
    for tag, root, cuts, on in (("other", other, CUTS, args.cuts),
                                ("this", here, CUTS_THIS, args.cuts_this)):
        if not on:
            continue
        src = (root / "src/repro_torch/kernels/csrc/decode_attention.cu"
               ).read_text()
        for name, spans in cuts.items():
            with tempfile.TemporaryDirectory() as tmp:
                csrc = Path(tmp) / "csrc"
                shutil.copytree(root / "src/repro_torch/kernels/csrc", csrc)
                (csrc / "decode_attention.cu").write_text(cut(src, spans))
                for kname, (ms, us) in run(root, csrc,
                                           Path(tmp) / "build").items():
                    print(f"{tag} without {name} {kname},{ms:.4f},{us:.1f}",
                          flush=True)


if __name__ == "__main__":
    main()
