"""Set-up: from the start of the process to the window's start (imports,
the kernels' load or build, the inputs, the program's build and the
first rounds)."""


def read(record):
    return record["setup_s"]
