"""Set-up seconds: from the harness's start to the window's (loading, the
port's build where it compiles, the runners' captures, the warm-up)."""


def read(w):
    return w["setup_s"]
