"""Give every test process its own compile cache.

The JAX engine persists compiled executables under ``SPARKDL_COMPILE_CACHE``
(default: one directory under the user's home). Shared by parallel test
workers and kept from one run to the next, that directory lets a test load
an executable that another test compiled for the 8-device data mesh and
call it with single-device arguments, which fails. So each pytest process
(the controller and every xdist worker) points the variable at a fresh
directory of its own and removes it at exit. Processes that tests spawn
inherit their parent's directory, so a restarted child still finds a warm
cache within a run; tests that set their own directory are unaffected.

A directory the caller set is respected. One that a parent pytest process
set here is not: ``_SPARKDL_TEST_COMPILE_CACHE`` marks it.
"""

import atexit
import os
import shutil
import tempfile

_VAR = "SPARKDL_COMPILE_CACHE"
_OWNED = "_SPARKDL_TEST_COMPILE_CACHE"

if _VAR not in os.environ or os.environ.get(_OWNED) == os.environ[_VAR]:
    _dir = tempfile.mkdtemp(prefix="sparkdl-exe-")
    os.environ[_VAR] = _dir
    os.environ[_OWNED] = _dir
    atexit.register(shutil.rmtree, _dir, ignore_errors=True)
