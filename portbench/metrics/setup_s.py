"""Seconds from the process's start to the window's start: imports, CUDA
set-up, footage, the program's set-up and its warm-up calls (with the
kernel builds on a cold checkout)."""


def read(outcome, cell):
    return outcome.setup_s
