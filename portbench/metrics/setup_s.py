"""setup_s: seconds from the process start to the first timed job (host
clock): the interpreter, torch and the CUDA context, the kernel library
(its nvcc build on a checkout's first run), the inputs, the program's
plan and one warm job."""


def read(rec):
    return rec.setup_s
