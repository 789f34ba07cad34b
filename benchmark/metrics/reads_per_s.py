"""Every read of the window's ``run()`` over that run's whole time, from
the call to the ``torch.cuda.synchronize()`` after it returns."""


def read(run):
    return run["reads"] / run["window_s"]
