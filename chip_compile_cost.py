#!/usr/bin/env python3
"""What ``chip_smoke.py``'s AOTInductor compiles and first loads cost the
host of a CUDA card, in fresh processes one at a time.

    python3 chip_compile_cost.py [PARTS] [THREADS]

1. the CPU-ISA probes: a fresh process times ``pick_vec_isa()`` (the
   question a process's first AOTInductor load asks), then the load of a
   small package, which then no longer probes;
2. each of ``PARTS`` (default ``vit,udf``; ``chip_smoke.P14_PARTS``) of phase
   14's programs compiled by ``chip_smoke.P14_PRECOMPILE`` under each of
   ``THREADS`` (default ``1,default``: ``TORCHINDUCTOR_COMPILE_THREADS=1``,
   and Inductor's own choice), each in a fresh process with its own
   Inductor cache: wall seconds and the CPU seconds of the process and its
   children.

Run it from the repository's tree on a machine with a card; it prints one
line a measurement and exits non-zero if a process failed."""

import gzip
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = str(Path(__file__).resolve().parent)

# a fresh process: pick_vec_isa() cold, then the first load of PACKAGE
ISA_PROBE = """
import json, sys, time
import torch, torch._inductor
import torch._inductor.cpu_vec_isa as cpu_vec_isa
torch.zeros(1, device="cuda")
t0 = time.perf_counter()
isa = cpu_vec_isa.pick_vec_isa()
probe_s = time.perf_counter() - t0
t0 = time.perf_counter()
torch._inductor.aoti_load_package(sys.argv[1])
print(json.dumps({"isa": str(isa), "probe_s": probe_s,
                  "load_s": time.perf_counter() - t0}))
"""

# a small package for ISA_PROBE to load
SMALL_PACKAGE = """
import sys, torch
module = torch.nn.Linear(64, 64).cuda()
program = torch.export.export(module, (torch.randn(8, 64, device="cuda"),))
torch._inductor.aoti_compile_and_package(program, package_path=sys.argv[1])
"""


def run(args, env):
    """``(CompletedProcess, wall s, CPU s of it and its children)``."""
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (after.ru_utime - before.ru_utime) + (after.ru_stime - before.ru_stime)
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"chip_compile_cost: {args[:2]} exited {proc.returncode}")
    return proc, wall, cpu


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    parts = (sys.argv[1] if len(sys.argv) > 1 else "vit,udf").split(",")
    threads = (sys.argv[2] if len(sys.argv) > 2 else "1,default").split(",")
    cs.host_build_env()
    os.environ.pop("TORCHINDUCTOR_COMPILE_THREADS", None)
    import numpy as np

    from sparkdl_tpu_torch.models.keras_model import write_keras_file
    from sparkdl_tpu_torch.ops.flash_attention import FLASH_FWD

    FLASH_FWD.build()
    with tempfile.TemporaryDirectory(prefix="chip-compile-cost-") as tmp:
        tmp = Path(tmp)
        package = str(tmp / "small.pt2")
        run(["-c", SMALL_PACKAGE, package], dict(os.environ))
        proc, wall, _ = run(["-c", ISA_PROBE, package],
                            dict(os.environ, TORCHINDUCTOR_CACHE_DIR=str(tmp / "isa-cache")))
        probe = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"CPU-ISA probes in a fresh process: pick_vec_isa() {probe['probe_s']:.2f} s "
              f"({probe['isa']}), then the first load {probe['load_s']:.4f} s; the process "
              f"{wall:.1f} s", flush=True)

        keras, block, rows = str(tmp / "i.keras"), str(tmp / "b.npy"), str(tmp / "r.npy")
        config = json.loads(gzip.decompress(cs.KERAS_CONFIG.read_bytes()))
        write_keras_file(keras, config, cs.keras_inception_weights(config, seed=11))
        np.save(block, cs.p14_images(32))
        for part in parts:
            for n in threads:
                env = dict(os.environ, SPARKDL_COMPILE_CACHE=str(tmp / f"p-{part}-{n}"),
                           TORCHINDUCTOR_CACHE_DIR=str(tmp / f"ind-{part}-{n}"))
                if n != "default":
                    env["TORCHINDUCTOR_COMPILE_THREADS"] = n
                code = cs.P14_PRECOMPILE.format(root=ROOT, prelude="", part=part,
                                                block=block, rows=rows, keras=keras)
                proc, wall, cpu = run(["-c", code], env)
                lines = [line for line in proc.stdout.splitlines()
                         if line.startswith("P14_PRECOMPILE ")]
                report = json.loads(lines[-1].split(" ", 1)[1])
                print(f"{part} compile, TORCHINDUCTOR_COMPILE_THREADS={n}: the process "
                      f"{wall:.1f} s wall, {cpu:.1f} s CPU; warmup {report['seconds']:.1f} s "
                      f"(engine.compile {report['compile_s']:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
