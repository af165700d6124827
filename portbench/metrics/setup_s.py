"""setup_s: from the process's start to the first timed request (s):
imports, CUDA initialisation, the kernel library's load (its build in
a fresh checkout), rendering the inputs on the card and the warm
request."""


def read(run):
    return run.setup_s
