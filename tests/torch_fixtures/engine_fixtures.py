"""Helpers of the engine's and the serving plane's tests, importable
without JAX (the warm-start test runs them in fresh processes):

- :func:`attention_block`, :func:`port_block`: a projection to q, k and v,
  the port's flash forward op and a tanh head, closing over seeded weights;
- :class:`ExportOnly`: stands in for the engine's compile and load in the
  tests of the logic around them (LRU, keys, single flight, the padded
  ladder): ``torch.export`` saved with ``torch.export.save`` and loaded as
  ``.module()``, no Inductor; it counts its compiles. Install it with
  :meth:`ExportOnly.install` on a ``monkeypatch``."""

import numpy as np
import torch


def attention_block(seed):
    """The seeded weights and a (3, 6, 16) input."""
    rng = np.random.default_rng(seed)
    w_qkv = rng.standard_normal((16, 3 * 2 * 32)).astype(np.float32) * 0.25
    w_out = rng.standard_normal((64, 5)).astype(np.float32) * 0.125
    x = rng.standard_normal((3, 6, 16)).astype(np.float32)
    return w_qkv, w_out, x


def port_block(w_qkv, w_out):
    from sparkdl_tpu_torch.ops.flash_attention import flash_attention

    wq, wo = torch.from_numpy(w_qkv), torch.from_numpy(w_out)

    def block(x):
        b, s, _ = x.shape
        qkv = (x @ wq).reshape(b, s, 3, 2, 32)
        o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return torch.tanh(o.reshape(b, s, 64) @ wo)

    return block


class ExportOnly:
    """A counting, export-only stand-in for ``engine.core.compile_package``
    and ``load_package``."""

    def __init__(self):
        self.compiled = []

    def compile(self, fn, example_args, path):
        from sparkdl_tpu_torch.engine import core

        self.compiled.append(path)
        torch.export.save(core.export_program(fn, example_args), path)

    @staticmethod
    def load(path):
        return torch.export.load(path).module()

    @classmethod
    def install(cls, monkeypatch) -> "ExportOnly":
        from sparkdl_tpu_torch.engine import core

        stub = cls()
        monkeypatch.setattr(core, "compile_package", stub.compile)
        monkeypatch.setattr(core, "load_package", stub.load)
        return stub
