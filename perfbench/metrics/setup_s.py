"""setup_s: seconds from the process's start to the window's (host clock):
interpreter, torch, the K1/K2 build or load, inputs, engine, the check's
first steps and one warm chunk."""


def read(ctx):
    return ctx["setup_s"]
