"""startup.import_s (s; layer: start-up): import torch and the port,
the CUDA context, the kernel library's and the C++ core's load (their
build, on a checkout's first run)."""


def read(run):
    return run.setup.get("import_s")
