"""Sweep the tile sizes of the flash-attention backward kernels on one card.

    python -m sparkdl_tpu_torch.ops.tile_sweep [--out sweep.json]

Builds ``csrc/flash_attention_bwd.cu`` once per tiling, one nvcc per variant,
all started together: rows per CTA of 64 or 32 and streamed tiles of 64,
32 or 16 rows, the same pair for dQ (Q rows, K/V tile) and for dK/dV (K/V rows, Q
tile), at every head_dim. For float32 and bfloat16 at (32, 197, 12, d), d in
32/64/128, with q/k/v as views of one fused qkv as ViT passes them, each
variant's dQ and dK/dV are held to the plain backward and timed with CUDA
events. Prints the card, one line per (dtype, head_dim, variant) and each
build's registers and spills; with ``--out``, writes the same as JSON. The
tiles the source keeps (``Tiles`` in the source) come from this sweep.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sparkdl_tpu_torch.ops.cuda_build import CudaKernel, build_library, ptxas_usage
from sparkdl_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    _launch_bwd,
    attention_delta,
    flash_attention,
    flash_attention_bwd_reference,
)

#: (rows per CTA, rows of a streamed tile), for both kernels
VARIANTS = ((64, 64), (64, 32), (64, 16), (32, 64), (32, 32), (32, 16))
SHAPE = (32, 197, 12)  # ViT-B/16 at 224, batch 32: (b, s, h)
TOL = {torch.float32: dict(atol=1e-3, rtol=1e-3),
       torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}


def defines(rows: int, tile: int) -> tuple:
    return (f"FLASH_BWD_DQ_ROWS={rows}", f"FLASH_BWD_DQ_KV={tile}",
            f"FLASH_BWD_DKV_ROWS={rows}", f"FLASH_BWD_DKV_Q={tile}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="a JSON file for the results")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA card is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    source = FLASH_BWD_DQ.source
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        logs = list(pool.map(lambda vt: build_library(source, defines(*vt))[1], VARIANTS))
    kernels = {
        vt: tuple(CudaKernel(source.name, k.symbol, k.argtypes, defines(*vt))
                  for k in (FLASH_BWD_DQ, FLASH_BWD_DKV))
        for vt in VARIANTS
    }
    usage = {f"{vt[0]}x{vt[1]}": ptxas_usage(log) for vt, log in zip(VARIANTS, logs)}
    for variant, kernels_usage in usage.items():
        for name, u in sorted(kernels_usage.items()):
            print(f"  {variant} {name}: {u}")

    b, s, h = SHAPE
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            gen = torch.Generator(device="cuda").manual_seed(d)
            fused = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(b, s, h, d) for t in fused.chunk(3, dim=-1))
            do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            out, lse = flash_attention(q, k, v, return_lse=True)
            delta = attention_delta(out, do)
            want = flash_attention_bwd_reference(q, k, v, out, lse, do)
            for vt, (kdq, kdkv) in kernels.items():
                dq = torch.empty_like(do)
                dk, dv = torch.empty_like(do), torch.empty_like(do)
                bwd = (q, k, v, do, lse, delta)
                rest = (False, d ** -0.5, s)

                def run_dq():
                    _launch_bwd(kdq, *bwd, (dq,), *rest)

                def run_dkv():
                    _launch_bwd(kdkv, *bwd, (dk, dv), *rest)

                run_dq()
                run_dkv()
                torch.cuda.synchronize()
                err = 0.0
                for g, w in zip((dq, dk, dv), want):
                    torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])
                    err = max(err, (g.float() - w.float()).abs().max().item())
                row = {"dtype": str(dtype).replace("torch.", ""), "head_dim": d,
                       "rows": vt[0], "tile": vt[1], "dq_ms": time_ms(run_dq),
                       "dkv_ms": time_ms(run_dkv), "max_abs_err": err}
                rows.append(row)
                print(f"{row['dtype']:8s} d={d:3d} rows {vt[0]:2d} tile {vt[1]:2d}: "
                      f"dQ {row['dq_ms']:.4f} ms, dK/dV {row['dkv_ms']:.4f} ms, "
                      f"max_abs_err {err:.3e}", flush=True)
    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"card": card, "shape": SHAPE, "rows": rows,
                                        "ptxas": usage}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
