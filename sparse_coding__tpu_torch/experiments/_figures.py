"""matplotlib for the experiments' figures, imported only where a figure is
drawn: the device halves run where matplotlib is not installed (the card's
machine has none), and an entry point asked for its figure there raises."""

from __future__ import annotations


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; raises `ImportError` naming
    matplotlib where it is missing (a figure is never skipped quietly)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("this experiment writes a figure and needs matplotlib, which is not installed; "
                          "its device half (the *_scores function) runs without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
