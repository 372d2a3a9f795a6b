"""The elastic remesh on 8 CPU ranks (gloo), the counterpart of
``tests/helpers/elastic_remesh_check.py``: reduced stablelm-1.6b crashes at
step 8 on a (2, 4) mesh with no restart left, a new run resumes from its
step-6 checkpoint on (4, 2) and finishes 12 steps; its last 3 losses within
3e-4 and its parameters within 2e-4 of an uninterrupted run with no mesh.
The reference's ``load_checkpoint`` reads the last checkpoint the sharded
run wrote, and finds the sharded run's final parameters in it.

The ranks run the ``elastic`` case of ``tests/test_torch_sharded_train.py``,
that file run as a script; this file starts it and holds its results.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.join(HERE, "..")
SCRIPT_LIMIT_S = 300


def _run_elastic(out_dir: str) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "test_torch_sharded_train.py"),
         "elastic", out_dir, str(port)], env=env, cwd=REPO,
        start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=SCRIPT_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the ranks outlived {SCRIPT_LIMIT_S} s")
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    with open(os.path.join(out_dir, "elastic.json")) as f:
        return json.load(f)


def test_elastic_remesh_resume_matches_uninterrupted(tmp_path):
    import jax
    from repro.checkpoint import load_checkpoint
    from repro.configs import get_reduced
    from repro.models import transformer as T
    from repro_torch.configs import get_reduced as port_reduced
    from repro_torch.convert import params_to_jax
    got = _run_elastic(str(tmp_path))
    assert got["crashed"]
    assert got["resumed_steps"] == [6, 7, 8, 9, 10, 11]
    np.testing.assert_allclose(got["resumed"][-3:], got["oracle"][-3:],
                               rtol=3e-4, atol=3e-4)
    assert got["params_not_close"] == []

    # the reference reads the sharded run's last checkpoint
    cfg = dataclasses.replace(get_reduced("stablelm-1.6b"),
                              param_dtype="float32", compute_dtype="float32")
    params = jax.eval_shape(lambda: T.init_params(cfg, jax.random.PRNGKey(0)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params)
    like = {"params": zeros, "opt": {"adam": {
        "mu": zeros, "nu": zeros, "step": np.zeros((), np.int32)}}}
    tree, step = load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 11
    with np.load(tmp_path / "final.npz") as z:
        final = {n: torch.from_numpy(z[n]) for n in z.files}
    want = params_to_jax(final, dataclasses.replace(
        port_reduced("stablelm-1.6b"), param_dtype="float32"))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), want)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree["params"]):
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))
