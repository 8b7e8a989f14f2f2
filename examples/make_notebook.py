"""Generate examples.ipynb from examples.py — one markdown + code cell per
example, mirroring the reference's examples.ipynb structure."""

import inspect
import json
import os

import examples


def cell_md(text):
    return {"cell_type": "markdown", "metadata": {},
            "source": text.splitlines(keepends=True)}


def cell_code(code):
    return {"cell_type": "code", "metadata": {}, "execution_count": None,
            "outputs": [], "source": code.splitlines(keepends=True)}


def main():
    cells = [cell_md(
        "# zaftpu examples\n\n"
        "The 12 examples of the reference (Zaf-Python `examples.ipynb`)\n"
        "recreated against the `zaftpu` API. Figures display\n"
        "inline; run top to bottom.\n"),
        cell_code(
            "import os\n"
            "import matplotlib.pyplot as plt\n"
            "import numpy as np\n"
            "import zaftpu\n"
            "from zaftpu.core.windows import hamming, kbd, vorbis\n"
            "from examples import load_audio, _analysis_params\n"
            "OUT = 'example_output'\n"
            "os.makedirs(OUT, exist_ok=True)\n")]

    for fn in examples.ALL:
        title = fn.__doc__.strip().rstrip(".")
        cells.append(cell_md(f"## {fn.__name__[len('example_'):]}\n\n{title}.\n"))
        src = inspect.getsource(fn)
        cells.append(cell_code(src + f"\n{fn.__name__}(OUT)\n"
                               "plt.close('all')\n"))

    nb = {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples.ipynb")
    with open(out, "w") as fh:
        json.dump(nb, fh, indent=1)
    print(f"wrote {out} ({len(cells)} cells)")


if __name__ == "__main__":
    main()
