#!/usr/bin/env python3
"""Run the PyTorch/H100 port (``sparkdl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run it from the repository's tree: it imports the package
``sparkdl_tpu_torch`` that lies beside it and builds the kernels from the
sources there. Alone, without the package, it stops in phase 1 and says so.

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):

1. device: the package imports from beside the script; a CUDA card is
   present; its name and power limit (nvidia-smi);
2. build: every kernel of the main path, from the sources in this checkout,
   one nvcc per source, all started together; each kernel's registers and
   spills (none allowed at head_dim 64) and its tensor-core products (HMMA)
   and cp.async copies (LDGSTS) in its SASS (both required in every forward
   and backward instance, and the head_dim 64 instances must be there);
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at the test shapes, q/k/v as views
   of one qkv tensor; gradients through the autograd Function against
   autograd of the plain forward; the forward's and the backward kernels'
   split-TF32 products at least 10x closer to the f32 plain version than
   single TF32 products, and their errors and the plain versions' against
   float64;
4. inference slice: ViT-B/16 image-file inference at full width through
   ``TorchImageFileTransformer`` over 64 generated 224x224 images, with
   random weights in the Flax layout carried across by
   ``vit_state_dict_from_flax``; flash rows held to the dense-attention rows
   and to a CPU run on two images; the kernel's launches on that run counted;
   the same in bfloat16 (``ViT(dtype=torch.bfloat16)``), held to the dense
   bfloat16 run, its launches counted and its forward timed;
5. training slice: ``TorchImageFileEstimator.fit`` of ViT-B/16 (10 classes,
   adam, 2 epochs of 2 steps at batch 32) over the same images; the forward
   with lse, dQ and dK/dV launches counted, and the lse-free forward's on
   the fitted transformer's transform; the first step's gradients and the
   four losses held to the dense-attention fit, one step at 2 images to a
   CPU fit; the caller's module unchanged by a fit with the defaults;
6. timing: each kernel, its plain version and the PyTorch library call that
   computes the same function (in float32 and bfloat16), with CUDA events;
   the model forward and the training step with the kernels and with dense
   attention; the inference slice's images/s and the training images/s of a
   second fit.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): float32 on
# the CUDA cores, bf16 on the tensor cores, float32 done as split TF32 on the
# tensor cores (three TF32 products per f32 product at 495 TFLOP/s), and HBM3.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "split_tf32": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12

F32_TOL = dict(atol=2e-4, rtol=2e-4)    # tests/test_ops.py's flash tolerance
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)   # tests/test_ops.py's flash-gradient tolerance
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 output rounding
# bf16 gradients: one bf16 rounding of the value (the kernels accumulate in
# float32 as the plain backward does, and round once at the store)
BF16_GRAD_TOL = dict(atol=1e-3, rtol=8e-3)
SLICE_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance
# bf16 ViT-B/16 rows, flash against dense attention, both bf16 on the card:
# the flash kernel keeps scores, P and the sums in float32 and rounds once at
# its output, the dense path rounds its scores and probabilities to bf16, so
# the two part by bf16 roundings (2**-9) compounded through 12 blocks:
# tests/test_torch_vit.py's bf16 bound, about 50 roundoffs at unit scale plus
# 2% of the value
BF16_SLICE_TOL = dict(atol=0.1, rtol=2e-2)
# flash vs dense training on the card, both float32: each gradient tensor to
# 1e-4 of its norm (of at least 1e-3 of the largest norm: the key bias's
# gradient is exactly zero, so float noise); the losses of 4 adam steps to
# 1e-4 relative (adam turns float noise in near-zero gradients into weight
# moves of up to lr); the weights as check_adam_step says, each leaf's change
# to 1e-2 of its norm
GRAD_NORM_RTOL = 1e-4
LOSS_RTOL = 1e-4
ADAM_LEAF_RTOL = 1e-2

VIT_SHAPE = (32, 197, 12, 64)  # ViT-B/16 at 224, batch 32: (b, s, h, d)
N_IMAGES = 64
BATCH = 32
N_CLASSES = 10
TRAIN_LR = 1e-4


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


def attention_bound_ms(shape, dtype_name: str, products: int = 2,
                       tensors: int = 4, rows: int = 0, rate: str = None):
    """Least time for one attention kernel: the larger of its bytes over HBM
    bandwidth and its operations over the peak rate for the type (or for
    ``rate``, a key of PEAK_FLOPS).

    ``products`` (b*h) x (s x s x d) matrix products of 2*s^2*d operations
    each; ``tensors`` (b, s, h, d) tensors in the input type and ``rows``
    (b, h, s) float32 vectors each read or written once. The forward: QK^T
    and PV, q/k/v read and o written (2, 4, 0). dQ: QK^T, dO V^T, dS K, with
    q/k/v/dO read, dQ written, lse and delta read (3, 5, 2). dK/dV: QK^T,
    dO V^T, P^T dO, dS^T Q, with q/k/v/dO read, dK and dV written, lse and
    delta read (4, 6, 2)."""
    b, s, h, d = shape
    itemsize = 4 if dtype_name == "float32" else 2
    nbytes = tensors * b * s * h * d * itemsize + rows * b * h * s * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = products * 2 * b * h * s * s * d / PEAK_FLOPS[rate or dtype_name] * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def fused_qkv(shape, dtype, seed):
    """One random (b, s, 3*h*d) projection on the card."""
    import torch

    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dtype)


def views(fused, shape):
    return [t.reshape(shape) for t in fused.chunk(3, dim=-1)]


def qkv_views(shape, dtype, seed):
    """q, k, v as views into one fused projection, as ViT passes them."""
    return views(fused_qkv(shape, dtype, seed), shape)


def cotangent(shape, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_backward(shape, dtype, kwargs, seed):
    """The backward kernels, reached through the autograd Function with q/k/v
    as views of one qkv leaf, against flash_attention_bwd_reference on the
    same inputs, out and lse; and, in float32, against autograd through the
    plain forward. Returns the max abs errors of (dQ, dK, dV)."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    fused = fused_qkv(shape, dtype, seed)
    q, k, v = views(fused, shape)
    do = cotangent(shape, dtype, seed)
    leaf = fused.clone().requires_grad_()
    flash_attention(*views(leaf, shape), **kwargs).backward(do)
    got = views(leaf.grad, shape)
    # the plain backward from the kernel's own out and lse, as the Function saves them
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, **kwargs)
    torch.cuda.synchronize()
    tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    errs = []
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **tol)
        errs.append((g.float() - w.float()).abs().max().item())
    line = (f"  {str(dtype):15s} {str(shape):20s} {str(kwargs):16s} "
            f"dq/dk/dv max_abs_err={errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}")
    if dtype == torch.float32:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(
            flash_attention_reference(*leaves, **kwargs), leaves, do
        )
        auto_err = 0.0
        for g, w in zip(got, auto):
            torch.testing.assert_close(g, w, **GRAD_TOL)
            auto_err = max(auto_err, (g - w).abs().max().item())
        line += f"; vs autograd of plain forward {auto_err:.3e}"
    log(line)
    return errs


def check_split_tf32(shape, seed):
    """The backward kernels compute each f32 product as three TF32 products
    (operands split in a TF32 value and its TF32 remainder). With inputs x4
    (a peaked softmax) their gradients must be at least 10x closer to the
    f32 plain backward than that plain backward run with TF32 products.
    Returns the kernels' max abs errors of (dQ, dK, dV)."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
    )

    fused = fused_qkv(shape, torch.float32, seed) * 4
    q, k, v = views(fused, shape)
    do = cotangent(shape, torch.float32, seed)
    leaf = fused.clone().requires_grad_()
    flash_attention(*views(leaf, shape)).backward(do)
    got = views(leaf.grad, shape)
    out, lse = flash_attention(q, k, v, return_lse=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        single = flash_attention_bwd_reference(q, k, v, out, lse, do)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = []
    for name, g, w, one in zip("qkv", got, want, single):
        err = (g - w).abs().max().item()
        single_err = (one - w).abs().max().item()
        log(f"  d{name}: kernels {err:.3e}, plain backward in TF32 {single_err:.3e} "
            f"({single_err / max(err, 1e-30):.0f}x)")
        if not 10 * err <= single_err:
            raise AssertionError(f"d{name}: split-TF32 error {err:.3e} is not 10x "
                                 f"under single TF32's {single_err:.3e}")
        errs.append(err)
    return errs


def check_split_tf32_forward(shape, seed):
    """The forward kernel computes each f32 product as three TF32 products.
    With inputs x4 (a peaked softmax) its output and lse must be at least
    10x closer to the f32 plain forward than that plain forward run with
    TF32 products. Returns the kernel's max abs errors of (out, lse)."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = views(fused_qkv(shape, torch.float32, seed) * 4, shape)
    got = flash_attention(q, k, v, return_lse=True)
    want = flash_attention_reference(q, k, v, return_lse=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        single = flash_attention_reference(q, k, v, return_lse=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = []
    for name, g, w, one in zip(("out", "lse"), got, want, single):
        err = (g - w).abs().max().item()
        single_err = (one - w).abs().max().item()
        log(f"  {name}: kernel {err:.3e}, plain forward in TF32 {single_err:.3e} "
            f"({single_err / max(err, 1e-30):.0f}x)")
        if not 10 * err <= single_err:
            raise AssertionError(f"{name}: split-TF32 error {err:.3e} is not 10x "
                                 f"under single TF32's {single_err:.3e}")
        errs.append(err)
    return errs


def forward_float64_errors(shape, seed):
    """The forward kernel and the plain f32 forward against a float64
    forward of the same f32 inputs: the output's relative error in norm and
    its bias (the mean error along the sign of each value, over the mean
    magnitude: below 0 where the output shrinks), the lse's max abs error
    and its mean error, for each. Logged, not held to a limit."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = qkv_views(shape, torch.float32, seed)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q64 * shape[3] ** -0.5, k64)
    lse64 = torch.logsumexp(logits, dim=-1)
    out64 = torch.einsum("bhqk,bkhd->bqhd", torch.exp(logits - lse64[..., None]), v64)
    errs = {}
    for name, (out, lse) in (("kernel", flash_attention(q, k, v, return_lse=True)),
                             ("plain f32", flash_attention_reference(q, k, v, return_lse=True))):
        diff, lse_diff = out.double() - out64, lse.double() - lse64
        errs[name] = ((diff.norm() / out64.norm()).item(),
                      ((diff * out64.sign()).mean() / out64.abs().mean()).item(),
                      lse_diff.abs().max().item(), lse_diff.mean().item())
        log(f"  {name}: out relative error {errs[name][0]:.3e}, bias {errs[name][1]:.3e}; "
            f"lse max abs error {errs[name][2]:.3e}, mean error {errs[name][3]:.3e}")
    return errs


def float64_errors(shape, seed):
    """The backward kernels and the plain f32 backward against a float64
    backward of the same f32 inputs (its own softmax, out and delta):
    relative errors in norm of (dQ, dK, dV) for each. Logged, not held to a
    limit: it shows how near f32 the split-TF32 products come."""
    import torch

    from sparkdl_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
    )

    q, k, v = qkv_views(shape, torch.float32, seed)
    do = cotangent(shape, torch.float32, seed)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    out, lse = flash_attention(q, k, v, return_lse=True)
    plain = flash_attention_bwd_reference(q, k, v, out, lse, do)
    scale = shape[3] ** -0.5
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q64 * scale, k64), dim=-1)
    out64 = torch.einsum("bhqk,bkhd->bqhd", p, v64)
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, v64)
    ds = p * (dp - (do64 * out64).sum(-1).transpose(1, 2)[..., None])
    exact = (torch.einsum("bhqk,bkhd->bqhd", ds, k64) * scale,
             torch.einsum("bhqk,bqhd->bkhd", ds, q64 * scale),
             torch.einsum("bhqk,bqhd->bkhd", p, do64))
    errs = {name: [((g.double() - w).norm() / w.norm()).item() for g, w in zip(grads, exact)]
            for name, grads in (("kernels", got), ("plain f32", plain))}
    for name, e in errs.items():
        log(f"  {name}: dq/dk/dv relative error {e[0]:.3e}/{e[1]:.3e}/{e[2]:.3e}")
    return errs


def check_kernel(shape, dtype, kwargs, seed):
    """Kernel vs plain version on the card; returns the max abs errs of the
    output and of the lse."""
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
    return err, lse_err


def flax_layout_vit_params(seed: int, classes: int = 1000):
    """Random ViT-B/16 weights in the Flax layout (kernels (in, out), conv
    HWIO, LayerNorm scale/bias), scaled like Flax's initialisers so the
    activations stay of unit order; the head has ``classes`` outputs."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std)

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), n_in ** -0.5),
                "bias": normal((n_out,), 0.02)}

    def norm(dim):
        return {"scale": 1.0 + normal((dim,), 0.1), "bias": normal((dim,), 0.1)}

    patch, dim, depth, mlp = 16, 768, 12, 3072
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


def run_slice(image_dir: Path, state_dict, attn_impl: str, device: str, uris=None,
              dtype=None):
    from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.sql.session import TorchSession

    stage = TorchImageFileTransformer(
        inputCol="uri", outputCol="features", imageLoader=load_npy,
        module=ViT(variant="ViT-B/16", attn_impl=attn_impl, dtype=dtype),
        state_dict=state_dict, batchSize=BATCH, device=device,
    )
    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    uris = uris or sorted(str(p) for p in image_dir.glob("*.npy"))
    df = session.createDataFrame([{"uri": u} for u in uris], numPartitions=1)
    return stage, df


def rows_array(rows) -> np.ndarray:
    return np.stack([r["features"].toArray() for r in rows])


def train_estimator(module, train_params, **kw):
    from sparkdl_tpu_torch.estimators import TorchImageFileEstimator

    args = dict(
        inputCol="uri", outputCol="features", labelCol="label",
        imageLoader=load_npy, module=module, optimizer="adam",
        fitParams={"epochs": 2, "batch_size": BATCH,
                   "learning_rate": TRAIN_LR, "seed": 0},
        initialVariables=train_params, device="cuda",
    )
    args.update(kw)
    return TorchImageFileEstimator(**args)


def training_df(uris):
    from sparkdl_tpu_torch.sql.session import TorchSession

    session = TorchSession.builder.appName("chip_smoke").getOrCreate()
    return session.createDataFrame(
        [{"uri": u, "label": i % N_CLASSES} for i, u in enumerate(uris)],
        numPartitions=1,
    )


def ce_per_sample(module, batch):
    import torch.nn.functional as F

    return F.cross_entropy(module(batch["x"]), batch["y"].long(), reduction="none")


def first_step_grads(state_dict, attn_impl, x, y):
    """Gradients of the first training step (mean CE over one batch)."""
    import torch

    from sparkdl_tpu_torch.models.vit import ViT

    model = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl=attn_impl)
    model.load_state_dict(state_dict, strict=True)
    model.cuda().train()
    loss = ce_per_sample(model, {"x": x, "y": y}).mean()
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def check_adam_step(got, want, start, steps):
    """Weights after ``steps`` adam steps from ``start`` in two runs: each
    within ``2 * steps * lr`` (adam moves a weight by about lr whatever its
    gradient's size, so where float noise flips the sign of a near-zero
    gradient the two runs step apart by up to 2 lr); and in every leaf, the
    key bias (the middle third of a qkv bias, whose gradient is exactly
    zero) split off, the change from ``start`` within ADAM_LEAF_RTOL of the
    other run's change in norm, so a leaf left unmoved or moved wrongly
    fails. Returns the largest difference and the worst leaf's error."""
    worst = 0.0
    worst_leaf = (0.0, "")
    for name, w in want.items():
        g = got[name].float().cpu()
        w = w.float().cpu()
        s = start[name].float().cpu()
        diff = (g - w).abs().max().item()
        if diff > 2 * steps * TRAIN_LR * 1.001:
            raise AssertionError(f"{name}: {diff:.3e} apart after {steps} adam steps")
        worst = max(worst, diff)
        parts = {name: slice(None)}
        if name.endswith("qkv.bias"):
            third = w.shape[-1] // 3
            parts = {f"{name}[q]": slice(0, third), f"{name}[v]": slice(2 * third, None)}
        for part, sl in parts.items():
            moved, other = (g - s)[..., sl], (w - s)[..., sl]
            err = ((moved - other).norm() / other.norm()).item()
            if not err <= ADAM_LEAF_RTOL:
                raise AssertionError(f"{part}: change differs by {err:.3e} of its norm")
            worst_leaf = max(worst_leaf, (err, part))
    return worst, worst_leaf


def import_package() -> bool:
    """Phase 1's first check: the port's package imports from beside this
    script. Says so plainly, naming the package and the directory, if not."""
    here = Path(__file__).resolve().parent
    if str(here) not in sys.path:
        sys.path.insert(0, str(here))
    try:
        import sparkdl_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the package sparkdl_tpu_torch from {here} "
              f"({exc}); run this script from the repository's tree, where "
              f"sparkdl_tpu_torch/ lies beside it", file=sys.stderr)
        return False
    return True


def main() -> int:
    import torch

    # phase 1: the package, the device
    if not import_package():
        return 1
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
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
        FLASH_FWD_LSE,
        attention_delta,
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step
    from sparkdl_tpu_torch.estimators.losses import get_optimizer
    from sparkdl_tpu_torch.utils.metrics import metrics

    kernels = (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)

    def reset_counts():
        for kernel in kernels:
            kernel.launches = 0

    def counts():
        return {k.symbol + ("+lse" if k is FLASH_FWD_LSE else ""): k.launches
                for k in kernels}

    # phase 2: build, one nvcc per source, all started together; the
    # launchers then load the libraries from the build directory
    from sparkdl_tpu_torch.ops.cuda_build import build_library, ptxas_usage, sass_opcodes

    t0 = time.perf_counter()
    sources = sorted({kernel.source for kernel in kernels})
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(build_library, sources))
    for kernel in kernels:
        kernel.build()
    log(f"build: {', '.join(src.name for src in sources)} in "
        f"{time.perf_counter() - t0:.1f} s")
    # registers and spills from nvcc's -Xptxas -v (empty for a cached
    # build), tensor-core products and cp.async copies from the SASS
    found = set()
    for library, build_log in built:
        usage = ptxas_usage(build_log)
        opcodes = sass_opcodes(library, ("HMMA", "LDGSTS", ""))
        found.update(opcodes)
        for kname in sorted(opcodes):
            u = usage.get(kname, {})
            log(f"  {kname}: {u.get('registers', '?')} registers, spill stores/loads "
                f"{u.get('spill_stores', '?')}/{u.get('spill_loads', '?')} bytes; "
                f"SASS HMMA {opcodes[kname]['HMMA']}, LDGSTS {opcodes[kname]['LDGSTS']} "
                f"of {opcodes[kname]['']} instructions")
            if kname.startswith(("flash_fwd_", "flash_bwd_")):
                if not (opcodes[kname]["HMMA"] and opcodes[kname]["LDGSTS"]):
                    raise AssertionError(f"{kname}: no tensor-core products or cp.async copies")
                if kname.endswith(",64>") and u.get("spill_stores", 0) + u.get("spill_loads", 0):
                    raise AssertionError(f"{kname} spills at head_dim 64: {u}")
    for kname in (f"{k}<{t},64>" for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                           "flash_bwd_dkv_kernel")
                  for t in ("f32", "bf16")):
        if kname not in found:
            raise AssertionError(f"no {kname} in the built libraries")

    # phase 3: kernel vs plain (forward f32 2e-4 and gradients f32 1e-3 as
    # tests/test_ops.py; bf16 forward 2e-2, bf16 gradients 8e-3 relative)
    test_shapes = [
        ((2, 197, 3, 64), {}), ((1, 128, 2, 32), {}), ((2, 300, 4, 128), {}),
        ((1, 197, 2, 64), {"causal": True}), ((1, 256, 2, 64), {"kv_len": 200}),
    ]
    log("kernel vs plain (flash_attention_fwd, with and without lse):")
    fwd_err, lse_err = check_kernel(VIT_SHAPE, torch.float32, {}, seed=0)
    check_kernel(VIT_SHAPE, torch.bfloat16, {}, seed=1)
    for shape, kwargs in test_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(shape, dtype, kwargs, seed=2)
    log("kernel vs plain (flash_attention_bwd_dq, flash_attention_bwd_dkv):")
    dq_err, dk_err, dv_err = check_backward(VIT_SHAPE, torch.float32, {}, seed=0)
    check_backward(VIT_SHAPE, torch.bfloat16, {}, seed=1)
    for shape, kwargs in test_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            check_backward(shape, dtype, kwargs, seed=3)
    log(f"split TF32 vs single TF32 (forward kernel, inputs x4, {VIT_SHAPE} float32):")
    check_split_tf32_forward(VIT_SHAPE, seed=5)
    log(f"split TF32 vs single TF32 (backward kernels, inputs x4, {VIT_SHAPE} float32):")
    check_split_tf32(VIT_SHAPE, seed=5)
    log(f"against a float64 forward ({VIT_SHAPE} float32 inputs):")
    forward_float64_errors(VIT_SHAPE, seed=6)
    log(f"against a float64 backward ({VIT_SHAPE} float32 inputs):")
    float64_errors(VIT_SHAPE, seed=6)

    # phase 4: the inference slice, ViT-B/16 at full width
    state = vit_state_dict_from_flax(flax_layout_vit_params(seed=0))
    train_params = flax_layout_vit_params(seed=2, classes=N_CLASSES)
    train_state = vit_state_dict_from_flax(train_params)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        image_dir = Path(tmp)
        rng = np.random.default_rng(1)
        for i in range(N_IMAGES):
            np.save(image_dir / f"img_{i:03d}.npy",
                    rng.random((224, 224, 3), dtype=np.float32))

        flash_stage, df = run_slice(image_dir, state, "flash", "cuda")
        reset_counts()
        t0 = time.perf_counter()
        flash_rows = flash_stage.transform(df).collect()
        first_s = time.perf_counter() - t0
        serve_counts = counts()
        expected = 12 * (N_IMAGES // BATCH)
        log(f"slice: {len(flash_rows)} rows, launches {serve_counts} "
            f"(expected {expected} lse-free: 12 blocks x {N_IMAGES // BATCH} batches), "
            f"first transform {first_s:.2f} s")
        if list(serve_counts.values()) != [expected, 0, 0, 0]:
            raise AssertionError(f"inference launches {serve_counts}")
        flash = rows_array(flash_rows)
        if flash.shape != (N_IMAGES, 1000) or not np.isfinite(flash).all():
            raise AssertionError(f"bad slice output: shape {flash.shape}")

        full_stage, full_df = run_slice(image_dir, state, "full", "cuda")
        full = rows_array(full_stage.transform(full_df).collect())
        np.testing.assert_allclose(flash, full, **SLICE_TOL)
        log(f"  flash vs full on the card: max_abs_err={np.abs(flash - full).max():.3e}")

        uris = [r["uri"] for r in flash_rows]
        cpu_stage, cpu_df = run_slice(image_dir, state, "full", "cpu", uris=uris[:2])
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

        # the same slice in bfloat16, through the bf16 forward kernel
        bf16_stage, _ = run_slice(image_dir, state, "flash", "cuda", dtype=torch.bfloat16)
        reset_counts()
        t0 = time.perf_counter()
        bf16 = rows_array(bf16_stage.transform(df).collect())
        bf16_first_s = time.perf_counter() - t0
        bf16_counts = counts()
        log(f"slice in bfloat16: {len(bf16)} rows, launches {bf16_counts} (expected "
            f"{expected} lse-free), first transform {bf16_first_s:.2f} s")
        if list(bf16_counts.values()) != [expected, 0, 0, 0]:
            raise AssertionError(f"bf16 inference launches {bf16_counts}")
        if bf16.shape != (N_IMAGES, 1000) or not np.isfinite(bf16).all():
            raise AssertionError(f"bad bf16 slice output: shape {bf16.shape}")
        full_bf16_stage, _ = run_slice(image_dir, state, "full", "cuda", dtype=torch.bfloat16)
        full_bf16 = rows_array(full_bf16_stage.transform(df).collect())
        np.testing.assert_allclose(bf16, full_bf16, **BF16_SLICE_TOL)
        log(f"  bf16 flash vs bf16 full on the card: "
            f"max_abs_err={np.abs(bf16 - full_bf16).max():.3e}; bf16 flash vs f32 "
            f"flash max_abs_err={np.abs(bf16 - flash).max():.3e}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            bf16_stage.transform(df).collect()
            walls.append(time.perf_counter() - t0)
        log(f"slice images/s in bfloat16 (ViT-B/16, batch {BATCH}, {N_IMAGES} images, "
            f"{card}): " + ", ".join(f"{N_IMAGES / w:.1f}" for w in walls))

        # the model forward alone, on one resident batch
        images = np.stack([load_npy(u) for u in uris])
        x = torch.from_numpy(images[:BATCH]).cuda()
        with torch.inference_mode():
            forward_ms = {
                impl: time_ms(lambda m=stage.module: m(x), iters=10)
                for impl, stage in (("flash", flash_stage), ("full", full_stage),
                                    ("flash_bf16", bf16_stage),
                                    ("full_bf16", full_bf16_stage))
            }
        del flash_stage, full_stage, cpu_stage, bf16_stage, full_bf16_stage

        # phase 5: the training slice, ViT-B/16 at full width, 10 classes
        labels = np.arange(N_IMAGES) % N_CLASSES
        train_df = training_df(uris)
        steps = 2 * (N_IMAGES // BATCH)

        # the first step's batch, as fit draws it, through flash and dense
        first = np.random.RandomState(0).permutation(N_IMAGES)[:BATCH]
        xb = torch.from_numpy(images[first]).cuda()
        yb = torch.from_numpy(labels[first]).cuda()
        flash_loss0, flash_grads = first_step_grads(train_state, "flash", xb, yb)
        full_loss0, full_grads = first_step_grads(train_state, "full", xb, yb)
        norms = {n: g.norm().item() for n, g in full_grads.items()}
        floor = 1e-3 * max(norms.values())
        grad_err = max((flash_grads[n] - g).norm().item() / max(norms[n], floor)
                       for n, g in full_grads.items())
        log(f"training: first-step gradients flash vs full on the card, largest "
            f"relative norm error {grad_err:.3e} (floor {floor:.3e}); loss "
            f"{flash_loss0:.6f} vs {full_loss0:.6f}")
        if grad_err > GRAD_NORM_RTOL:
            raise AssertionError(f"first-step gradients differ by {grad_err:.3e}")
        del flash_grads, full_grads

        caller_module = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash")
        before = {n: t.clone() for n, t in caller_module.state_dict().items()}
        estimator = train_estimator(caller_module, train_params)
        reset_counts()
        t0 = time.perf_counter()
        fitted = estimator.fit(train_df)
        torch.cuda.synchronize()
        first_fit_s = time.perf_counter() - t0
        fit_counts = counts()
        expected = 12 * steps
        log(f"training: fit of {steps} steps, launches {fit_counts} (expected "
            f"{expected} with lse, dQ and dK/dV: 12 blocks x {steps} steps; "
            f"0 lse-free), first fit {first_fit_s:.2f} s")
        if list(fit_counts.values()) != [0, expected, expected, expected]:
            raise AssertionError(f"training launches {fit_counts}")
        for n, t in caller_module.state_dict().items():
            if not torch.equal(t, before[n]):
                raise AssertionError(f"fit changed the caller's module: {n}")

        full_fit = train_estimator(
            ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="full"),
            train_params,
        ).fit(train_df)
        losses = np.array(fitted._training_losses)
        full_losses = np.array(full_fit._training_losses)
        log(f"  losses flash {losses.tolist()} vs full {full_losses.tolist()}")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"bad training losses {losses}")
        np.testing.assert_allclose(losses, full_losses, rtol=LOSS_RTOL)
        adam_diff, adam_leaf = check_adam_step(
            fitted.module.state_dict(), full_fit.module.state_dict(), train_state, steps
        )
        log(f"  weights flash vs full after {steps} adam steps: largest "
            f"difference {adam_diff:.3e}; worst leaf change error "
            f"{adam_leaf[0]:.3e} ({adam_leaf[1]})")
        del full_fit

        reset_counts()
        tuned_rows = rows_array(fitted.transform(df).collect())
        tuned_counts = counts()
        log(f"  fitted transformer: {len(tuned_rows)} rows, launches {tuned_counts}")
        # the fitted transformer batches at the default transform batch size
        from sparkdl_tpu_torch.transformers.utils import DEFAULT_BATCH_SIZE

        if list(tuned_counts.values()) != [12 * -(-N_IMAGES // DEFAULT_BATCH_SIZE), 0, 0, 0]:
            raise AssertionError(f"fitted transform launches {tuned_counts}")
        if tuned_rows.shape != (N_IMAGES, N_CLASSES) or not np.isfinite(tuned_rows).all():
            raise AssertionError(f"bad fitted rows: shape {tuned_rows.shape}")

        # one step at 2 images, on the card and on the CPU
        small_df = training_df(uris[:2])
        small = {"fitParams": {"epochs": 1, "batch_size": 2,
                               "learning_rate": TRAIN_LR, "seed": 0}}
        card_fit = train_estimator(
            ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash"),
            train_params, **small,
        ).fit(small_df)
        cpu_fit = train_estimator(
            ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash"),
            train_params, device="cpu", **small,
        ).fit(small_df)
        np.testing.assert_allclose(card_fit._training_losses,
                                   cpu_fit._training_losses, rtol=LOSS_RTOL)
        cpu_diff, cpu_leaf = check_adam_step(
            card_fit.module.state_dict(), cpu_fit.module.state_dict(), train_state, 1
        )
        card_rows = rows_array(card_fit.transform(small_df).collect())
        cpu_rows = rows_array(cpu_fit.transform(small_df).collect())
        np.testing.assert_allclose(card_rows, cpu_rows, **SLICE_TOL)
        log(f"  one step at 2 images, card vs CPU: loss {card_fit._training_losses} "
            f"vs {cpu_fit._training_losses}; weights largest difference "
            f"{cpu_diff:.3e}, worst leaf change error {cpu_leaf[0]:.3e} "
            f"({cpu_leaf[1]}); rows "
            f"max_abs_err={np.abs(card_rows - cpu_rows).max():.3e}")
        del card_fit, cpu_fit

        # a fit with the defaults (weights drawn from the seed) leaves the
        # caller's module as it was
        default_module = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl="flash")
        before = {n: t.clone() for n, t in default_module.state_dict().items()}
        from sparkdl_tpu_torch.estimators import TorchImageFileEstimator

        TorchImageFileEstimator(
            inputCol="uri", outputCol="features", labelCol="label",
            imageLoader=load_npy, module=default_module,
        ).fit(train_df)
        for n, t in default_module.state_dict().items():
            if not torch.equal(t, before[n]):
                raise AssertionError(f"a default fit changed the caller's module: {n}")
        log("  a fit with the defaults left the caller's module unchanged")

        # training images/s, steady state: a second fit
        metrics.reset()
        t0 = time.perf_counter()
        estimator.fit(train_df)
        fit_s = time.perf_counter() - t0
        step_s = metrics.timer("estimator.step").seconds
        n_steps = metrics.counter("estimator.steps").value
        log(f"training images/s (ViT-B/16, adam, batch {BATCH}, {steps} steps, {card}): "
            f"fit {2 * N_IMAGES / fit_s:.1f} ({fit_s:.3f} s, loading and copies "
            f"included); estimator.step {n_steps * BATCH / step_s:.1f} "
            f"({int(n_steps)} steps, {1e3 * step_s / n_steps:.3f} ms each)")

        # the training step alone, on one resident batch
        step_ms = {}
        for impl in ("flash", "full"):
            model = ViT(variant="ViT-B/16", num_classes=N_CLASSES, attn_impl=impl)
            model.load_state_dict(train_state, strict=True)
            model.cuda().train()
            train = init_train_state(model, get_optimizer("adam", TRAIN_LR))
            step = make_train_step(ce_per_sample)
            batch = {"x": xb, "y": yb, "w": torch.ones(BATCH, device="cuda")}
            step_ms[impl] = time_ms(lambda: step(train, batch), iters=5, warmup=2)
            del model, train

    # phase 6: timing at the main path's shape (f32, q/k/v views of one qkv)
    records = []
    q, k, v = qkv_views(VIT_SHAPE, torch.float32, seed=0)
    b, s, h, d = VIT_SHAPE
    scale = d ** -0.5
    ms = time_ms(lambda: flash_attention(q, k, v), iters=20)
    lse_ms = time_ms(lambda: flash_attention(q, k, v, return_lse=True), iters=20)
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: sdpa(qt, kt, vt), iters=20)
    # the least time: f32 work as split TF32 on the tensor cores, as the
    # kernels do it; beside it the bound on the CUDA cores (67 TFLOP/s f32)
    bound_ms, bound_by = attention_bound_ms(VIT_SHAPE, "float32", rate="split_tf32")
    core_bound_ms = attention_bound_ms(VIT_SHAPE, "float32")[0]
    log(f"forward timing at {VIT_SHAPE} float32 ({card}): kernel {ms:.4f} ms "
        f"(with lse {lse_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms split TF32 ({bound_by}; {core_bound_ms:.4f} ms CUDA cores)")
    log(f"ViT-B/16 forward at batch {BATCH} float32 ({card}): "
        f"flash {forward_ms['flash']:.3f} ms, full {forward_ms['full']:.3f} ms; "
        f"12 kernel launches {12 * ms:.3f} ms = "
        f"{100 * 12 * ms / forward_ms['flash']:.1f}% of the flash forward")
    qb, kb, vb = qkv_views(VIT_SHAPE, torch.bfloat16, seed=1)
    bf16_ms = time_ms(lambda: flash_attention(qb, kb, vb), iters=20)
    bf16_lse_ms = time_ms(lambda: flash_attention(qb, kb, vb, return_lse=True), iters=20)
    qbt, kbt, vbt = (t.transpose(1, 2) for t in (qb, kb, vb))
    bf16_library_ms = time_ms(lambda: sdpa(qbt, kbt, vbt), iters=20)
    bf16_bound, bf16_by = attention_bound_ms(VIT_SHAPE, "bfloat16")
    log(f"forward timing at {VIT_SHAPE} bfloat16 ({card}): kernel {bf16_ms:.4f} ms "
        f"(with lse {bf16_lse_ms:.4f} ms), scaled_dot_product_attention "
        f"{bf16_library_ms:.4f} ms, bound {bf16_bound:.4f} ms ({bf16_by})")
    bf16_share = 12 * bf16_ms / forward_ms["flash_bf16"]
    log(f"ViT-B/16 forward at batch {BATCH} bfloat16 ({card}): "
        f"flash {forward_ms['flash_bf16']:.3f} ms, full {forward_ms['full_bf16']:.3f} ms; "
        f"12 kernel launches {12 * bf16_ms:.3f} ms = {100 * bf16_share:.1f}% of the "
        f"flash forward")

    out, lse = flash_attention(q, k, v, return_lse=True)
    do = cotangent(VIT_SHAPE, torch.float32, seed=0)
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta, False, scale, s)
    dq_ms = time_ms(lambda: flash_attention_bwd_dq(*args), iters=20)
    dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(*args), iters=20)
    delta_ms = time_ms(lambda: attention_delta(out, do), iters=20)
    bwd_plain_ms = time_ms(
        lambda: flash_attention_bwd_reference(q, k, v, out, lse, do), iters=5
    )
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    flash_out = flash_attention(*leaves)
    bwd_ms = time_ms(
        lambda: torch.autograd.grad(flash_out, leaves, do, retain_graph=True), iters=20
    )
    t_leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    sdpa_out = sdpa(*t_leaves)
    do_t = do.transpose(1, 2)
    bwd_library_ms = time_ms(
        lambda: torch.autograd.grad(sdpa_out, t_leaves, do_t, retain_graph=True), iters=20
    )
    dq_bound, dq_by = attention_bound_ms(VIT_SHAPE, "float32", 3, 5, 2, "split_tf32")
    dkv_bound, dkv_by = attention_bound_ms(VIT_SHAPE, "float32", 4, 6, 2, "split_tf32")
    dq_core = attention_bound_ms(VIT_SHAPE, "float32", 3, 5, 2)[0]
    dkv_core = attention_bound_ms(VIT_SHAPE, "float32", 4, 6, 2)[0]
    log(f"backward timing at {VIT_SHAPE} float32 ({card}): dQ kernel {dq_ms:.4f} ms "
        f"(bound {dq_bound:.4f} ms split TF32, {dq_by}; {dq_core:.4f} ms CUDA cores), "
        f"dK/dV kernel {dkv_ms:.4f} ms (bound {dkv_bound:.4f} ms split TF32, {dkv_by}; "
        f"{dkv_core:.4f} ms CUDA cores), delta {delta_ms:.4f} ms; "
        f"backward through autograd {bwd_ms:.4f} ms vs scaled_dot_product_attention's "
        f"backward {bwd_library_ms:.4f} ms; plain backward {bwd_plain_ms:.4f} ms")
    ob, lseb = flash_attention(qb, kb, vb, return_lse=True)
    dob = cotangent(VIT_SHAPE, torch.bfloat16, seed=1)
    bf16_args = (qb, kb, vb, dob, lseb, attention_delta(ob, dob), False, scale, s)
    dq_bf16 = time_ms(lambda: flash_attention_bwd_dq(*bf16_args), iters=20)
    dkv_bf16 = time_ms(lambda: flash_attention_bwd_dkv(*bf16_args), iters=20)
    leaves_bf16 = [t.detach().requires_grad_() for t in (qb, kb, vb)]
    flash_out_bf16 = flash_attention(*leaves_bf16)
    bwd_bf16_ms = time_ms(
        lambda: torch.autograd.grad(flash_out_bf16, leaves_bf16, dob, retain_graph=True),
        iters=20,
    )
    t_leaves_bf16 = [t.detach().transpose(1, 2).requires_grad_() for t in (qb, kb, vb)]
    sdpa_out_bf16 = sdpa(*t_leaves_bf16)
    dob_t = dob.transpose(1, 2)
    bwd_library_bf16_ms = time_ms(
        lambda: torch.autograd.grad(sdpa_out_bf16, t_leaves_bf16, dob_t, retain_graph=True),
        iters=20,
    )
    log(f"backward timing at {VIT_SHAPE} bfloat16 ({card}): dQ {dq_bf16:.4f} ms "
        f"(bound {attention_bound_ms(VIT_SHAPE, 'bfloat16', 3, 5, 2)[0]:.4f} ms), "
        f"dK/dV {dkv_bf16:.4f} ms "
        f"(bound {attention_bound_ms(VIT_SHAPE, 'bfloat16', 4, 6, 2)[0]:.4f} ms); "
        f"backward through autograd {bwd_bf16_ms:.4f} ms vs "
        f"scaled_dot_product_attention's backward {bwd_library_bf16_ms:.4f} ms")
    kernel_ms = 12 * (lse_ms + dq_ms + dkv_ms)
    log(f"ViT-B/16 training step at batch {BATCH} float32, adam ({card}): flash "
        f"{step_ms['flash']:.3f} ms, full {step_ms['full']:.3f} ms; 12 x (forward "
        f"with lse + dQ + dK/dV) = {kernel_ms:.3f} ms = "
        f"{100 * kernel_ms / step_ms['flash']:.1f}% of the flash step")

    source = "sparkdl_tpu_torch/ops/csrc/flash_attention_{}.cu"
    common = {"route": "cuda"}
    # bound_ms: split TF32 on the tensor cores, as the kernels compute;
    # cuda_core_bound_ms: the same work on the CUDA cores; bf16_ms and
    # bf16_library_ms: the kernel and the library call on bf16 inputs
    records.append({
        "name": "flash_attention_fwd", **common, "source": source.format("fwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:284",
        # the lse-free launches: inference (f32 and bf16) and the fitted transform
        "launches": (serve_counts["flash_attention_fwd"] + bf16_counts["flash_attention_fwd"]
                     + tuned_counts["flash_attention_fwd"]),
        "max_abs_err": fwd_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "cuda_core_bound_ms": core_bound_ms,
        "library_ms": library_ms, "bf16_ms": bf16_ms, "bf16_library_ms": bf16_library_ms,
    })
    records.append({
        "name": "flash_attention_fwd_lse", **common, "source": source.format("fwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:259",
        "launches": fit_counts["flash_attention_fwd+lse"],
        "max_abs_err": max(fwd_err, lse_err), "ms": lse_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "cuda_core_bound_ms": core_bound_ms,
        "library_ms": library_ms, "bf16_ms": bf16_lse_ms, "bf16_library_ms": bf16_library_ms,
    })
    # no single library call computes dQ or dK/dV alone: library_ms is the
    # backward of scaled_dot_product_attention, set against dQ + dK/dV + delta
    # (the line above); plain_ms is flash_attention_bwd_reference, which
    # computes all three gradients
    records.append({
        "name": "flash_attention_bwd_dq", **common, "source": source.format("bwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:317",
        "launches": fit_counts["flash_attention_bwd_dq"], "max_abs_err": dq_err,
        "ms": dq_ms, "plain_ms": bwd_plain_ms, "bound_ms": dq_bound,
        "bound_by": dq_by, "cuda_core_bound_ms": dq_core, "library_ms": bwd_library_ms,
        "bf16_ms": dq_bf16, "bf16_library_ms": bwd_library_bf16_ms,
    })
    records.append({
        "name": "flash_attention_bwd_dkv", **common, "source": source.format("bwd"),
        "replaces": "sparkdl_tpu/ops/flash_attention.py:340",
        "launches": fit_counts["flash_attention_bwd_dkv"],
        "max_abs_err": max(dk_err, dv_err), "ms": dkv_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": dkv_bound, "bound_by": dkv_by, "cuda_core_bound_ms": dkv_core,
        "library_ms": bwd_library_ms, "bf16_ms": dkv_bf16,
        "bf16_library_ms": bwd_library_bf16_ms,
    })

    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
