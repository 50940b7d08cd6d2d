"""setup_s (s, host clock): from the process's start to the first timed
job: the interpreter, torch's import, CUDA's context, the inputs made from
the seed, and one job that builds or loads the kernels and warms every
shape the window uses."""


def read(run):
    return run.setup_s
