"""nvcc builds of the port's CUDA sources (csrc/*.cu) at first use.

Each source is compiled for sm_90a into its own shared library with a plain
C interface under build/hp3d_torch_kernels/, with nvcc's register and
shared-memory report in a log beside it, and loaded with ctypes by the
module that launches it: ops/rasterizer_cuda.py (`librasterize.so`),
ops/lapack_svd3.py (`libsvd3_gesdd.so`) and ops/svd3.py
(`libsvd3_jacobi.so`), so a path loads only the kernels it runs.
"""

import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hp3d_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    nvcc = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return nvcc


def build_library(src_path, lib_path, log_path):
    """Compile one .cu file into `lib_path` (skipped while the library is
    newer than the source), nvcc's `-Xptxas -v` report into `log_path`.

    :return: lib_path
    """
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(src_path)):
        return lib_path
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp, src_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {os.path.basename(src_path)}:\n"
                           f"{proc.stdout}")
    with open(log_path, "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, lib_path)
    return lib_path
