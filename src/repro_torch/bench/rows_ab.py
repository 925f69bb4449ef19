"""Rows 1, 3 and 4 (paged decode, contiguous decode, verify) of this
checkout against another checkout's, on the card, in turns on the same
inputs: the other, this, this, the other, each in a process of its own
that builds its own tree's library.  With ``--cuts-this`` this checkout's
kernel is timed again once for each part in `CUTS_THIS` cut out of its
source (which part holds its time).

  python -m repro_torch.bench.rows_ab --other DIR [--cuts-this]

``DIR`` is a checkout (say an unpacked ``git archive`` of the parent commit
under ``build/``).  Shapes are `chip_smoke.py`'s kernels phase: qwen3-0.6b
(B 8, 16/8 heads, D 128), contiguous decode at S 1024 and bkv 128 with one
slot at S + 6, verify at T 5 through a 64-page table of 16-row pages,
paged decode (T 1) through the same table; label base; bf16 and int8;
then paged decode on int8 pools at qwen2-moe's shape (`chip_smoke.py`
`DEC8`: 16/16 heads, 32 pages of 16 a slot, positions 64-286).  A
row is ``<tree> <kernel>,ms,host_us``: the median device time of one call
with L2 flushed (`common.time_ms`) and the host time of one call's
enqueue.  A cut-out's output is wrong by design: only its time
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

# (name, [(first text, last text[, replacement])]): each span of this
# checkout's `rows_kernel`, both ends included, is cut out (or replaced)
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

    def kv(n, ps, dead, quant, hkv=hkv):
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
        calls[f"paged {'int8' if quant else 'bf16'}"] = (
            lambda k=k, v=v, sc=sc: dec.paged_decode_attention(
                q1, k, v, bt, pos0, **sc))
    # qwen2-moe's int8 pools: G 1, the serve phase's short slots
    npp8 = 32
    n8 = b * npp8 + 5
    perm = torch.randperm(n8 - 1, generator=gen, device="cuda")[:b * npp8]
    bt8 = (perm + 1).reshape(b, npp8).to(torch.int32)
    pos8 = torch.randint(64, 287, (b,), generator=gen, device="cuda")
    rows = torch.arange(npp8 * ps, device="cuda")
    dead8 = torch.ones(n8, ps, dtype=torch.bool, device="cuda")
    dead8[bt8.long()[:, rows // ps], (rows % ps).expand(b, -1)] = \
        rows[None, :] > pos8[:, None]
    pos8 = pos8.to(torch.int32)
    k8, v8, sc8 = kv(n8, ps, dead8, True, hkv=h)
    calls["paged int8 qwen2-moe"] = (
        lambda: dec.paged_decode_attention(q1, k8, v8, bt8, pos8, **sc8))
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
    if not args.cuts_this:
        return
    src = (here / "src/repro_torch/kernels/csrc/decode_attention.cu"
           ).read_text()
    for name, spans in CUTS_THIS.items():
        with tempfile.TemporaryDirectory() as tmp:
            csrc = Path(tmp) / "csrc"
            shutil.copytree(here / "src/repro_torch/kernels/csrc", csrc)
            (csrc / "decode_attention.cu").write_text(cut(src, spans))
            for kname, (ms, us) in run(here, csrc,
                                       Path(tmp) / "build").items():
                print(f"this without {name} {kname},{ms:.4f},{us:.1f}",
                      flush=True)


if __name__ == "__main__":
    main()
