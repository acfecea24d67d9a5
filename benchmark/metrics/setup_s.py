"""setup_s: from the start of the process to the window's first call:
imports, the card's start, the scene's build, the settle (and on a
checkout's first run the kernels' builds), the captures and the warm-up."""


def read(run):
    return run.setup_s
