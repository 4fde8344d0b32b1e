"""Output tokens stamped inside the window, over the window's length."""


def read(run):
    n = sum(1 for s in run.served for t in s.token_times if t <= run.close)
    return n / run.seconds
