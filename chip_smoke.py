#!/usr/bin/env python3
"""Run the PyTorch/H100 port (``sparkdl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. device: a CUDA card is present; its name and power limit (nvidia-smi);
2. build: every kernel of the main path, from the sources in this checkout;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at the test shapes;
4. slice: ViT-B/16 image-file inference at full width through
   ``TorchImageFileTransformer`` over 64 generated 224x224 images, with
   random weights in the Flax layout carried across by
   ``vit_state_dict_from_flax``; flash rows held to the dense-attention rows
   and to a CPU run on two images; the kernel's launches on that run counted;
5. timing: each kernel, its plain version and the PyTorch library call that
   computes the same function, with CUDA events; the model forward with the
   kernel and with dense attention; the slice's images/s.

The last lines are the card's name and power limit, one JSON object of
kernel records, and ``{"ok": true, "device": {...}}``. Float32 matrix
products and convolutions run in full float32 (TF32 off) throughout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): float32 on
# the CUDA cores, bf16 on the tensor cores, and HBM3.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

F32_TOL = dict(atol=2e-4, rtol=2e-4)    # tests/test_ops.py's flash tolerance
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 output rounding
SLICE_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance

VIT_SHAPE = (32, 197, 12, 64)  # ViT-B/16 at 224, batch 32: (b, s, h, d)
N_IMAGES = 64
BATCH = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

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


def attention_bound_ms(shape, dtype_name: str):
    """Least time for one forward: the larger of its bytes (q, k, v read
    once, o written once) over HBM bandwidth and its operations (QK^T and
    PV, 4*b*h*s^2*d) over the peak rate for the type."""
    b, s, h, d = shape
    itemsize = 4 if dtype_name == "float32" else 2
    bytes_ms = 4 * b * s * h * d * itemsize / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * s * s * d / PEAK_FLOPS[dtype_name] * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def qkv_views(shape, dtype, seed):
    """q, k, v as views into one fused projection, as ViT passes them."""
    import torch

    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return [t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1)]


def check_kernel(shape, dtype, kwargs, seed):
    """Kernel vs plain version on the card; returns the output's max abs err."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = qkv_views(shape, dtype, seed)
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    want, want_lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    log(f"  {str(dtype):15s} {str(shape):20s} {str(kwargs):16s} "
        f"max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e}")
    return err


def flax_layout_vit_params(seed: int):
    """Random ViT-B/16 weights in the Flax layout (kernels (in, out), conv
    HWIO, LayerNorm scale/bias), scaled like Flax's initialisers so the
    activations stay of unit order."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), n_in ** -0.5),
                "bias": normal((n_out,), 0.02)}

    def norm(dim):
        return {"scale": 1.0 + normal((dim,), 0.1), "bias": normal((dim,), 0.1)}

    patch, dim, depth, mlp, classes = 16, 768, 12, 3072, 1000
    params = {
        "patch_embed": {"kernel": normal((patch, patch, 3, dim), (patch * patch * 3) ** -0.5),
                        "bias": normal((dim,), 0.02)},
        "cls_token": normal((1, 1, dim), 0.02),
        "pos_embed": normal((1, 197, dim), 0.02),
        "ln_final": norm(dim),
        "head": dense(dim, classes),
    }
    for i in range(depth):
        params[f"block_{i}"] = {
            "ln_1": norm(dim), "qkv": dense(dim, 3 * dim), "proj": dense(dim, dim),
            "ln_2": norm(dim), "mlp_up": dense(dim, mlp), "mlp_down": dense(mlp, dim),
        }
    return {"params": params}


def load_npy(uri):
    return np.load(uri)


def run_slice(image_dir: Path, state_dict, attn_impl: str, device: str, uris=None):
    from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.sql.session import TorchSession

    stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="features", imageLoader=load_npy,
        module=ViT(variant="ViT-B/16", attn_impl=attn_impl),
        state_dict=state_dict, batchSize=BATCH, device=device,
    )
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    uris = uris or sorted(str(p) for p in image_dir.glob("*.npy"))
    df = session.createDataFrame([{"uri": u} for u in uris], numPartitions=1)
    return stage, df


def rows_array(rows) -> np.ndarray:
    return np.stack([r["features"].toArray() for r in rows])


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
    from sparkdl_tpu_torch.ops.flash_attention import (
        FLASH_FWD,
        flash_attention,
        flash_attention_reference,
    )
    from sparkdl_tpu_torch.utils.metrics import metrics

    # phase 2: build
    t0 = time.perf_counter()
    FLASH_FWD.build()
    log(f"build: {FLASH_FWD.source.name} in {time.perf_counter() - t0:.1f} s")
    for line in FLASH_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  {line.strip()}")

    # phase 3: kernel vs plain (f32 2e-4 as tests/test_ops.py; bf16 2e-2)
    log("kernel vs plain (flash_attention_fwd):")
    main_err = check_kernel(VIT_SHAPE, torch.float32, {}, seed=0)
    check_kernel(VIT_SHAPE, torch.bfloat16, {}, seed=1)
    for shape, kwargs in [
        ((2, 197, 3, 64), {}), ((1, 128, 2, 32), {}), ((2, 300, 4, 128), {}),
        ((1, 197, 2, 64), {"causal": True}), ((1, 256, 2, 64), {"kv_len": 200}),
    ]:
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(shape, dtype, kwargs, seed=2)

    # phase 4: the slice, ViT-B/16 at full width
    state = vit_state_dict_from_flax(flax_layout_vit_params(seed=0))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        image_dir = Path(tmp)
        rng = np.random.default_rng(1)
        for i in range(N_IMAGES):
            np.save(image_dir / f"img_{i:03d}.npy",
                    rng.random((224, 224, 3), dtype=np.float32))

        flash_stage, df = run_slice(image_dir, state, "flash", "cuda")
        FLASH_FWD.launches = 0
        t0 = time.perf_counter()
        flash_rows = flash_stage.transform(df).collect()
        first_s = time.perf_counter() - t0
        launches = FLASH_FWD.launches
        expected = 12 * (N_IMAGES // BATCH)
        log(f"slice: {len(flash_rows)} rows, flash_attention_fwd launches={launches} "
            f"(expected {expected}: 12 blocks x {N_IMAGES // BATCH} batches), "
            f"first transform {first_s:.2f} s")
        if launches != expected:
            raise AssertionError(f"kernel launched {launches} times, expected {expected}")
        flash = rows_array(flash_rows)
        if flash.shape != (N_IMAGES, 1000) or not np.isfinite(flash).all():
            raise AssertionError(f"bad slice output: shape {flash.shape}")

        full_stage, full_df = run_slice(image_dir, state, "full", "cuda")
        full = rows_array(full_stage.transform(full_df).collect())
        np.testing.assert_allclose(flash, full, **SLICE_TOL)
        log(f"  flash vs full on the card: max_abs_err={np.abs(flash - full).max():.3e}")

        uris = [r["uri"] for r in flash_rows[:2]]
        cpu_stage, cpu_df = run_slice(image_dir, state, "full", "cpu", uris=uris)
        cpu = rows_array(cpu_stage.transform(cpu_df).collect())
        np.testing.assert_allclose(flash[:2], cpu, **SLICE_TOL)
        log(f"  flash on the card vs full on the CPU (2 images): "
            f"max_abs_err={np.abs(flash[:2] - cpu).max():.3e}")

        # slice throughput, steady state (weights resident, kernel built):
        # host wall time per transform, and the loop's own metrics
        walls = []
        metrics.reset()
        for _ in range(5):
            t0 = time.perf_counter()
            flash_stage.transform(df).collect()
            walls.append(time.perf_counter() - t0)
        log(f"slice images/s (ViT-B/16, batch {BATCH}, {N_IMAGES} images, {card}): "
            + ", ".join(f"{N_IMAGES / w:.1f}" for w in walls)
            + f"; median {N_IMAGES / float(np.median(walls)):.1f}"
            + f"; sparkdl.serve rate {metrics.images_per_sec():.1f}")
        log("  " + ", ".join(f"{k}={v:.4f}" for k, v in
                             sorted(metrics.snapshot("sparkdl.").items())))

        # the model forward alone, on one resident batch
        x = torch.from_numpy(np.stack([load_npy(r["uri"]) for r in flash_rows[:BATCH]]))
        x = x.cuda()
        with torch.inference_mode():
            forward_ms = {
                impl: time_ms(lambda m=stage.module: m(x), iters=10)
                for impl, stage in (("flash", flash_stage), ("full", full_stage))
            }

    # phase 5: timing at the main path's shape (f32, q/k/v views of one qkv)
    records = []
    q, k, v = qkv_views(VIT_SHAPE, torch.float32, seed=0)
    ms = time_ms(lambda: flash_attention(q, k, v), iters=20)
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v), iters=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), iters=20
    )
    bound_ms, bound_by = attention_bound_ms(VIT_SHAPE, "float32")
    log(f"timing at {VIT_SHAPE} float32 ({card}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    log(f"ViT-B/16 forward at batch {BATCH} float32 ({card}): "
        f"flash {forward_ms['flash']:.3f} ms, full {forward_ms['full']:.3f} ms; "
        f"12 kernel launches {12 * ms:.3f} ms = "
        f"{100 * 12 * ms / forward_ms['flash']:.1f}% of the flash forward")
    qb, kb, vb = qkv_views(VIT_SHAPE, torch.bfloat16, seed=1)
    bf16_ms = time_ms(lambda: flash_attention(qb, kb, vb), iters=20)
    bf16_bound, bf16_by = attention_bound_ms(VIT_SHAPE, "bfloat16")
    log(f"timing at {VIT_SHAPE} bfloat16 ({card}): kernel {bf16_ms:.4f} ms, "
        f"bound {bf16_bound:.4f} ms ({bf16_by})")
    records.append({
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "sparkdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "sparkdl_tpu/ops/flash_attention.py:284",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    })

    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
