"""setup_s: seconds from the process's start to the window's (imports,
CUDA start, kernel load or build, data drawn on the card, the program's
state allocated, one warm step or chunk)."""


def read(records):
    return records.get("setup_s")
