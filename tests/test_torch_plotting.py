"""Port parity, the experiment summary tool: ``gaussianimage_tpu_torch.
plotting`` against ``gaussianimage_tpu.plotting`` on the same roots of
fake runs (tests/test_plotting.py's) and on the ``training.npy`` that the
port's fit CLI writes: the same decoded names, runs, summary rows, printed
table and CLI output; the plot smoke skips without matplotlib."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gaussianimage_tpu import plotting as j_plotting  # noqa: E402
from gaussianimage_tpu_torch import plotting  # noqa: E402
from gaussianimage_tpu_torch import train as port_train  # noqa: E402

NAMES = ("GaussianImage_Cholesky_50000_10000", "GaussianImage_RS_1000_800",
         "maskGI_Ch_ada_kl_tgt0.6_lam0.001_init-1.0_50000_30000_ema",
         "maskGI_Ch_kl_tgt0.7_lam0.005_init2.0_3000_16000", "notanexperiment")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two torch threads per test: the suite's parallel workers would
    oversubscribe the CPU with torch's default of one thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _fake_run(root, exp, img, psnr, pts):
    d = root / exp / img
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "training.npy", {
        "iterations": [1000], "training_psnr": [psnr - 1.0],
        "training_time": 12.0, "psnr": psnr, "ms-ssim": 0.95,
        "rendering_time": 0.001, "rendering_fps": 1000.0,
        "final_points": pts})


@pytest.fixture(scope="module")
def port_cli_root(tmp_path_factory):
    """The port's fit CLI on the synthetic dataset's first image at 32x48:
    50 iterations of 128 points, on two torch threads as every test here
    (this module-wide fixture runs before the per-test pin); returns its
    checkpoint root."""
    root = tmp_path_factory.mktemp("cli")
    real = port_train.iterate_dataset
    mp = pytest.MonkeyPatch()
    mp.setattr(port_train, "iterate_dataset",
               lambda name, d: itertools.islice(
                   real(name, d, image_hw=(32, 48)), 1))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port_train.main(["--data_name", "synthetic", "--iterations", "50",
                         "--num_points", "128", "--device", "cpu",
                         "--checkpoint_root", str(root), "--chunk_size",
                         "50", "--viz_every", "0"])
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return root / "synthetic"


def _fake_root(root):
    _fake_run(root, NAMES[0], "a", 40.0, 10000)
    _fake_run(root, NAMES[0], "b", 42.0, 10000)
    _fake_run(root, NAMES[1], "a", 39.0, 800)
    _fake_run(root, NAMES[2], "kodim01", 35.5, 21000)
    return root


def test_parse_experiment_name_is_the_jax_package_s():
    for name in NAMES:
        assert plotting.parse_experiment_name(name) == \
            j_plotting.parse_experiment_name(name)


@pytest.mark.parametrize("source", ["fake", "port_cli"])
def test_summaries_equal_the_jax_package_s(source, tmp_path, port_cli_root,
                                           capsys):
    """The same runs (filtered and excluded alike), summary rows, printed
    table and CLI output from both modules."""
    root = (str(_fake_root(tmp_path)) if source == "fake"
            else str(port_cli_root))
    runs = plotting.collect_runs(root)
    j_runs = j_plotting.collect_runs(root)
    assert runs and sorted(runs) == sorted(j_runs)
    for exp in runs:
        np.testing.assert_equal(runs[exp], j_runs[exp])
    rows = plotting.summarize(runs)
    np.testing.assert_equal(rows, j_plotting.summarize(j_runs))
    if source == "port_cli":
        (exp, n, psnr, ms, fpts, pk, fps), = rows
        assert (exp, n, fpts) == ("GaussianImage_Cholesky_50_128", 1, 128)
        assert np.isfinite([psnr, ms, fps]).all()
    for f, e in (((), ()), (("RS",), ()), ((), ("RS",))):
        assert sorted(plotting.collect_runs(root, f, e)) == sorted(
            j_plotting.collect_runs(root, f, e))
    plotting.print_summary(rows)
    port_out = capsys.readouterr().out
    j_plotting.print_summary(j_plotting.summarize(j_runs))
    assert port_out == capsys.readouterr().out
    plotting.main(["--root", root])
    port_out = capsys.readouterr().out
    j_plotting.main(["--root", root])
    assert port_out == capsys.readouterr().out and "experiment" in port_out


def test_plot_comparison_smoke(tmp_path):
    pytest.importorskip("matplotlib")
    runs = plotting.collect_runs(str(_fake_root(tmp_path / "runs")))
    out = tmp_path / "plot.png"
    plotting.plot_comparison(runs, str(out))
    assert out.exists() and out.stat().st_size > 1000
