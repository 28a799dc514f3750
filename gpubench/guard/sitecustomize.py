"""Import guard of the benchmark's Python children: refuses ``jax``,
``jaxlib``, ``flax`` and the JAX package ``tpumon`` (whole top-level
names: ``tpumon_torch`` passes) and logs each refusal to the file
``GPUBENCH_IMPORT_LOG`` names."""

import os
import sys

_REFUSED = {"jax", "jaxlib", "flax", "tpumon"}


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _REFUSED:
            log = os.environ.get("GPUBENCH_IMPORT_LOG")
            if log:
                with open(log, "a") as f:
                    f.write(f"{os.getpid()} {name}\n")
            raise ImportError(f"{name} refused in a benchmark process")
        return None


sys.meta_path.insert(0, _Refuse())
