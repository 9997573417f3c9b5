"""Sweep the tile sizes of the flash-attention kernels on one card.

    python -m sparkdl_tpu_torch.ops.tile_sweep [--out sweep.json]

Builds each source once per tiling, one nvcc per variant, all started
together. The forward (``csrc/flash_attention_fwd.cu``): Q rows per CTA of
32, 64 or 128 and streamed K/V tiles of 16, 32 or 64 rows, held to the plain
forward (output and lse) in float32 at head_dim 32/64/128 and in bfloat16 at
64, and timed with and without the lse. The backward
(``csrc/flash_attention_bwd.cu``): rows per CTA of 64 or 32 and streamed
tiles of 64, 32 or 16 rows, the same pair for dQ (Q rows, K/V tile) and for
dK/dV (K/V rows, Q tile), held to the plain backward in float32 and bfloat16
at every head_dim. All at (32, 197, 12, d), with q/k/v as views of one fused
qkv as ViT passes them, timed with CUDA events. A variant whose shared
memory does not fit the card is reported as such. Prints the card, one line
per (kernel, dtype, head_dim, variant) and each build's registers and
spills; with ``--out``, writes the same as JSON. The tiles the sources keep
(``Tiles`` in each) come from this sweep.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sparkdl_tpu_torch.ops.cuda_build import (
    CudaKernel,
    KernelLaunchError,
    build_library,
    ptxas_usage,
)
from sparkdl_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    _launch_bwd,
    _launch_fwd,
    attention_delta,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

#: forward: (Q rows per CTA, rows of a streamed K/V tile)
FWD_VARIANTS = tuple((rows, kv) for rows in (32, 64, 128) for kv in (16, 32, 64))
#: backward: (rows per CTA, rows of a streamed tile), for both kernels
BWD_VARIANTS = ((64, 64), (64, 32), (64, 16), (32, 64), (32, 32), (32, 16))
SHAPE = (32, 197, 12)  # ViT-B/16 at 224, batch 32: (b, s, h)
FWD_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
BWD_TOL = {torch.float32: dict(atol=1e-3, rtol=1e-3),
           torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}
FWD_CASES = ((torch.float32, 32), (torch.float32, 64), (torch.float32, 128),
             (torch.bfloat16, 64))


def fwd_defines(rows: int, kv: int) -> tuple:
    return (f"FLASH_FWD_ROWS={rows}", f"FLASH_FWD_KV={kv}")


def bwd_defines(rows: int, tile: int) -> tuple:
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


def _qkv(dtype, d, seed):
    b, s, h = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fused = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in fused.chunk(3, dim=-1))
    return q, k, v, gen


def _max_err(got, want, tol) -> float:
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **tol)
        err = max(err, (g.float() - w.float()).abs().max().item())
    return err


def sweep_fwd(kernels) -> list:
    rows = []
    for dtype, d in FWD_CASES:
        q, k, v, _ = _qkv(dtype, d, seed=d)
        want = flash_attention_reference(q, k, v, return_lse=True)
        out, lse = torch.empty_like(q), torch.empty(want[1].shape, device="cuda")
        for vt, kernel in kernels.items():
            args = (False, d ** -0.5, SHAPE[1])
            row = {"kernel": "fwd", "dtype": str(dtype).replace("torch.", ""),
                   "head_dim": d, "rows": vt[0], "tile": vt[1]}
            try:
                _launch_fwd(kernel, q, k, v, out, lse, *args)
            except KernelLaunchError as exc:  # shared memory past the card's
                row["error"] = str(exc)
                rows.append(row)
                print(f"fwd {row['dtype']:8s} d={d:3d} rows {vt[0]:3d} tile {vt[1]:2d}: "
                      f"{exc}", flush=True)
                continue
            torch.cuda.synchronize()
            row["max_abs_err"] = _max_err((out,), want[:1], FWD_TOL[dtype])
            row["lse_max_abs_err"] = _max_err((lse,), want[1:], FWD_TOL[torch.float32])
            row["fwd_ms"] = time_ms(lambda: _launch_fwd(kernel, q, k, v, out, None, *args))
            row["fwd_lse_ms"] = time_ms(lambda: _launch_fwd(kernel, q, k, v, out, lse, *args))
            rows.append(row)
            print(f"fwd {row['dtype']:8s} d={d:3d} rows {vt[0]:3d} tile {vt[1]:2d}: "
                  f"{row['fwd_ms']:.4f} ms, with lse {row['fwd_lse_ms']:.4f} ms, "
                  f"max_abs_err {row['max_abs_err']:.3e}", flush=True)
    return rows


def sweep_bwd(kernels) -> list:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128):
            q, k, v, gen = _qkv(dtype, d, seed=d)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            out, lse = flash_attention(q, k, v, return_lse=True)
            delta = attention_delta(out, do)
            want = flash_attention_bwd_reference(q, k, v, out, lse, do)
            for vt, (kdq, kdkv) in kernels.items():
                dq = torch.empty_like(do)
                dk, dv = torch.empty_like(do), torch.empty_like(do)
                bwd = (q, k, v, do, lse, delta)
                rest = (False, d ** -0.5, SHAPE[1])

                def run_dq():
                    _launch_bwd(kdq, *bwd, (dq,), *rest)

                def run_dkv():
                    _launch_bwd(kdkv, *bwd, (dk, dv), *rest)

                run_dq()
                run_dkv()
                torch.cuda.synchronize()
                err = _max_err((dq, dk, dv), want, BWD_TOL[dtype])
                row = {"kernel": "bwd", "dtype": str(dtype).replace("torch.", ""),
                       "head_dim": d, "rows": vt[0], "tile": vt[1],
                       "dq_ms": time_ms(run_dq), "dkv_ms": time_ms(run_dkv),
                       "max_abs_err": err}
                rows.append(row)
                print(f"bwd {row['dtype']:8s} d={d:3d} rows {vt[0]:2d} tile {vt[1]:2d}: "
                      f"dQ {row['dq_ms']:.4f} ms, dK/dV {row['dkv_ms']:.4f} ms, "
                      f"max_abs_err {err:.3e}", flush=True)
    return rows


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

    # (kernel family, variant, source, defines)
    builds = ([("fwd", vt, FLASH_FWD.source, fwd_defines(*vt)) for vt in FWD_VARIANTS]
              + [("bwd", vt, FLASH_BWD_DQ.source, bwd_defines(*vt)) for vt in BWD_VARIANTS])
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        logs = list(pool.map(lambda bd: build_library(bd[2], bd[3])[1], builds))
    usage = {f"{fam} {vt[0]}x{vt[1]}": ptxas_usage(log)
             for (fam, vt, _, _), log in zip(builds, logs)}
    for variant, kernels_usage in usage.items():
        for name, u in sorted(kernels_usage.items()):
            print(f"  {variant} {name}: {u}")

    rows = sweep_fwd({
        vt: CudaKernel(src.name, FLASH_FWD.symbol, FLASH_FWD.argtypes, defs)
        for fam, vt, src, defs in builds if fam == "fwd"
    })
    rows += sweep_bwd({
        vt: tuple(CudaKernel(src.name, k.symbol, k.argtypes, defs)
                  for k in (FLASH_BWD_DQ, FLASH_BWD_DKV))
        for fam, vt, src, defs in builds if fam == "bwd"
    })
    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"card": card, "shape": SHAPE, "rows": rows,
                                        "ptxas": usage}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
