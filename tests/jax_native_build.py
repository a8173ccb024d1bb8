"""The JAX package's native module (its C++ YAML / BMP / mask helpers), for
the port's tests that compare against it.

``seamlesscloneoptimization_tpu.native`` builds its extension with g++ when
first imported, into the package directory; test workers that import it at
once may race, and a worker whose load failed has ``HAVE_NATIVE`` False.
``jax_native()`` then builds the same source into a private temporary
directory, loads it, and puts it in the module's place for this process
(nothing in the JAX package's files changes), so the comparisons always
run against the JAX package's C++ code.
"""

import importlib.util
import subprocess
import sysconfig
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SCNATIVE = REPO / "seamlesscloneoptimization_tpu" / "native" / "src" / "scnative.cpp"


def jax_native():
    from seamlesscloneoptimization_tpu import native

    if not native.HAVE_NATIVE:
        out = Path(tempfile.mkdtemp(prefix="scnative_")) / "scnative.so"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        f"-I{sysconfig.get_paths()['include']}", str(SCNATIVE), "-o", str(out)],
                       check=True, capture_output=True)
        spec = importlib.util.spec_from_file_location("scnative", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        native._native, native.HAVE_NATIVE = mod, True
    return native
