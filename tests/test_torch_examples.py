"""The port's examples run on the CPU (``--cpu``: the plain versions) at
small sizes and print their self-check lines: the bucket sort equals
``np.sort`` of its keys, the assembled contig occurs in the simulated
genome, and the quickstart reaches its end."""

import importlib.util
from pathlib import Path

import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse: one torch thread)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"



def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_keys", [5000, 1 << 13])
def test_isx_sort_verifies(capsys, n_keys):
    _load("torch_isx_sort").main(["--cpu", str(n_keys)])
    out = capsys.readouterr().out
    assert f"sorted {n_keys} keys" in out and "on cpu: verified" in out


def test_genome_assembly_walks_a_true_contig(capsys):
    _load("torch_genome_assembly").main(["--cpu", "--genome-len", "4096"])
    out = capsys.readouterr().out
    assert "(0 drops)" in out
    assert "contig matches reference genome: True" in out
    walked = int(out.split("walked a contig of ")[1].split()[0])
    assert walked > 20


def test_quickstart_reaches_its_end(capsys):
    _load("torch_quickstart").main("cpu")
    assert "quickstart OK" in capsys.readouterr().out
