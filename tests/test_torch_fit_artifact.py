"""The port's fit artifact (cudagaussianrenderer_torch.tools.fit_artifact)
against the JAX package's tools/fit_artifact.py on the CPU, in both dataset
layouts: 300 splats fitted from a 300-splat scene, 3 views at 64x64, 5
steps.

``run()`` writes the JAX record's keys and files; its ``psnr_init_db`` lies
within 0.1 dB of the JAX tool's on the same arguments and its
``loss_first`` within 1e-3 relative.  The JAX tool runs as a subprocess
with JAX_PLATFORMS=cpu, both layouts at once: each takes ~2 min, nearly
all of it compiling its Renderer's frame for each capacity key of each of
its three Renderers in interpret mode (~15 s a compile), so this file
runs ~2 min, longer than the ~30 s of the other port files."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from cudagaussianrenderer_torch.tools import fit_artifact

from torch_port_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--scene-splats", "300", "--fit-splats", "300", "--views", "3", "--size", "64",
        "--steps", "5"]
LAYOUTS = ("transforms", "colmap")
RECORD_KEYS = ("backend", "scene_splats", "fit_splats_final", "views", "size", "steps",
               "densify_every", "optimizer", "layout", "perturb_poses", "refine_poses",
               "loss_first", "loss_last", "psnr_init_db", "psnr_fit_db", "fit_seconds",
               "ms_per_step")
FILES = ("fit_dataset.json", "fit_init.png", "fit_final.png", "fit_target.png")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """layout -> (the port's record, the JAX tool's record)."""
    tmp = tmp_path_factory.mktemp("fit_artifact")
    # One XLA compute thread a run: the two runs share the host with the
    # suite's other workers.
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_CPU_ENABLE_ASYNC_DISPATCH="false",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    jax_runs = {
        layout: subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / "fit_artifact.py"), *ARGS, "--layout", layout,
             "--out", str(tmp / f"jax_{layout}"), "--dataset-dir", str(tmp / f"jax_ds_{layout}")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for layout in LAYOUTS
    }
    try:
        port = {layout: fit_artifact.main([*ARGS, "--layout", layout, "--device", "cpu",
                                           "--out", str(tmp / f"port_{layout}")])
                for layout in LAYOUTS}
        out = {}
        for layout, proc in jax_runs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-2000:]
            out[layout] = (port[layout], json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in jax_runs.values():
            proc.kill()
    return tmp, out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_run_writes_the_jax_record(records, layout):
    tmp, out = records
    got, want = out[layout]
    assert tuple(got) == RECORD_KEYS and tuple(want) == RECORD_KEYS
    assert got["backend"] == "cpu" and got["layout"] == layout
    for k in ("scene_splats", "fit_splats_final", "views", "size", "steps", "optimizer"):
        assert got[k] == want[k], k
    assert json.loads((tmp / f"port_{layout}" / "fit_dataset.json").read_text()) == got
    for name in FILES:
        assert (tmp / f"port_{layout}" / name).stat().st_size > 0, name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_psnr_and_first_loss_match_the_jax_tool(records, layout):
    got, want = records[1][layout]
    assert abs(got["psnr_init_db"] - want["psnr_init_db"]) <= 0.1, (got, want)
    assert abs(got["loss_first"] - want["loss_first"]) <= 1e-3 * abs(want["loss_first"])


def test_default_out_is_a_new_directory():
    args = fit_artifact.parser().parse_args([])
    assert args.out == "artifacts/torch_h100" and args.dataset_dir is None
    assert (args.steps, args.views, args.size, args.optimizer) == (600, 10, 256, "adam")
