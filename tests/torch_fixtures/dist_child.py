"""One rank of a :mod:`dist_launch` group (run as a script).

``python dist_child.py <module:function> <kwargs.pt> <out.pt>``: joins the
gloo group named by ``SPARKDL_COORDINATOR`` / ``SPARKDL_NUM_PROCS`` /
``SPARKDL_PROC_ID``, calls the function with the saved keyword arguments
and saves its result. Imports torch and the port only.
"""

import importlib
import sys

import torch


def main() -> int:
    target, args_file, out_file = sys.argv[1:4]
    torch.set_num_threads(1)
    from sparkdl_tpu_torch.parallel import runner

    runner.initialize(device="cpu", timeout_s=120.0)
    module, name = target.split(":")
    kwargs = torch.load(args_file, weights_only=False)
    result = getattr(importlib.import_module(module), name)(**kwargs)
    torch.save(result, out_file)
    rank = runner.process_index()
    runner.barrier()
    runner.shutdown()
    print(f"DIST_CHILD_OK {rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
