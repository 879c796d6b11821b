"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
repository's root. Tests that need a CUDA card carry the ``card`` marker
and skip inside the test where there is none; on a machine with an H100
run them with ``python3 -m pytest portbench/tests -q -m card``."""

import sys
from pathlib import Path

import pytest

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips inside the test where "
        "there is none)")


def _small(cell):
    """(train images, test images, eval window) of a whole run the CPU
    holds at the cell's batch."""
    b = cell["training_params"]["BATCH_SZ"]
    return (100, 40, 40) if b <= 20 else (3 * b, 2 * b, 2 * b)


@pytest.fixture
def small(monkeypatch):
    """Cut the data of every cell to a size the CPU runs whole: the cells'
    and configurations' files are read as they are and cut on the way."""
    from portbench import cells

    real_cell, real_config = cells.cell, cells.config
    sizes = {}

    def cell(name):
        c = real_cell(name)
        n_train, n_test, window = _small(c)
        sizes[c["config"]] = (n_train, n_test)
        return dict(c, training_params=dict(c["training_params"],
                                            TEST_SAMP_SZ=window))

    def config(name):
        n_train, n_test = sizes[name]
        return dict(real_config(name), train_images=n_train,
                    test_images=n_test)

    monkeypatch.setattr(cells, "cell", cell)
    monkeypatch.setattr(cells, "config", config)
