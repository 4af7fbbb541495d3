"""Analysis layer (``rcu_tpu.analysis`` counterpart): eval-CSV discovery,
columnar frames read with the stdlib ``csv`` module and numpy, and the
LaTeX writer of the paper's tables. No pandas; matplotlib only in the
functions of ``cli/`` that draw, through :func:`pyplot`."""
from rcu_tpu_torch.analysis import frames, latex, resultdata  # noqa: F401


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported by a function that
    draws (the tables' machines may lack matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt
