"""Set-up: from the process's start to the window's, compilation included."""


def read(r):
    return r.setup_s
