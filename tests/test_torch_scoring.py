"""The port's scoring side-car (aletsch_tpu_torch/scoring) against the JAX
package's, on the CPU device.

The forest descent runs as plain PyTorch on the port's device from 256
rows up and must equal _predict_numpy bit for bit (f32 compares, the mean
over trees added in tree order); the JAX package's XLA path takes its mean
in another order, so the torch path is held to it within 1e-6.  sklearn's
own probabilities are f64 and agree to 1e-5 on both paths, as in
tests/test_scoring.py.  The committed .npz fixture is the .joblib model
converted by ForestArrays.from_sklearn, for hosts without joblib.  The
score and train CLIs give the reference's bytes with jax and the JAX
package unimportable."""

import os
import subprocess
import sys

import numpy as np
import pytest

import test_scoring_reference as ref_tests
from aletsch_tpu.scoring import forest as ref_forest
from aletsch_tpu.scoring import score as ref_score
from aletsch_tpu.scoring import train as ref_train
from aletsch_tpu_torch.scoring import forest as port_forest
from aletsch_tpu_torch.scoring import score as port_score
from aletsch_tpu_torch.scoring import train as port_train
from aletsch_tpu_torch.scoring.forest import (ForestArrays, predict_proba,
                                              synthetic_forest, train_forest)
from torch_helpers import REPO, blocked_env

FIXTURE = os.path.join(REPO, "tests", "fixtures", "rf_model_50f")
ARRAYS = ("feature", "threshold", "left", "right", "prob")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(800, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 3] - 0.2 * X[:, 7] > 0).astype(int)
    fa, model = train_forest(X, y, n_estimators=25, max_depth=8)
    return X, y, fa, model


@pytest.fixture(scope="module")
def forests(fitted):
    """name -> forest: sklearn's, the committed fixture, and a synthetic
    one at the trainer's defaults (100 trees, max_depth 20)."""
    return {"fitted": fitted[2],
            "fixture": ForestArrays.load(FIXTURE + ".npz"),
            "synthetic": synthetic_forest()}


def _rows(fa, n, seed):
    width = int(fa.feature.max()) + 1
    return np.random.default_rng(seed).normal(size=(n, width)) \
        .astype(np.float32)


def _bits(p):
    assert p.dtype == np.float32
    return p.view(np.int32)


def test_matches_sklearn(fitted):
    X, y, fa, model = fitted
    ref = model.predict_proba(X)[:, 1]
    assert np.allclose(ref, predict_proba(fa, X, use_jax=False), atol=1e-5)


def test_torch_path_matches_sklearn(fitted):
    X, y, fa, model = fitted
    before = dict(port_forest.stats)
    ours = predict_proba(fa, X, use_jax=True)
    assert np.allclose(model.predict_proba(X)[:, 1], ours, atol=1e-5)
    assert port_forest.stats["forest_dispatches"] == \
        before["forest_dispatches"] + 1
    assert port_forest.stats["forest_rows"] == before["forest_rows"] + 800


@pytest.mark.parametrize("n", [256, 1000, 4096])
@pytest.mark.parametrize("name", ["fitted", "fixture", "synthetic"])
def test_torch_path_bit_for_bit_numpy(forests, name, n):
    fa = forests[name]
    X = _rows(fa, n, seed=n)
    got = predict_proba(fa, X, use_jax=True)
    want = port_forest._predict_numpy(fa, X)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(want),
                          _bits(ref_forest._predict_numpy(fa, X)))


@pytest.mark.parametrize("name", ["fitted", "fixture", "synthetic"])
def test_torch_path_against_the_jax_package(forests, name):
    """The JAX package's XLA mean may differ from numpy's by an ulp."""
    fa = forests[name]
    X = _rows(fa, 1000, seed=7)
    got = predict_proba(fa, X, use_jax=True)
    want = ref_forest.predict_proba(fa, X, use_jax=True)
    assert got.shape == want.shape == (1000,)
    assert np.allclose(got, want, rtol=0, atol=1e-6)


def test_rows_below_256_stay_in_numpy(forests):
    fa = forests["synthetic"]
    X = _rows(fa, 255, seed=3)
    before = dict(port_forest.stats)
    got = predict_proba(fa, X, use_jax=True)
    assert port_forest.stats == before
    assert np.array_equal(_bits(got),
                          _bits(ref_forest.predict_proba(fa, X)))


def test_device_failure_propagates(forests, monkeypatch):
    """No fallback to numpy: a device the port cannot use raises."""
    fa = forests["fixture"]
    X = _rows(fa, 300, seed=4)
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        predict_proba(fa, X)


def test_synthetic_forest_reaches_its_depth(forests):
    fa = forests["synthetic"]
    assert fa.feature.shape[0] == 100 and fa.max_depth == 20
    for t in range(fa.feature.shape[0]):
        depth = {0: 0}
        for i in np.flatnonzero(fa.feature[t] >= 0):
            depth[fa.left[t, i]] = depth[fa.right[t, i]] = depth[i] + 1
        assert max(depth.values()) == 20
    again = synthetic_forest()
    for k in ARRAYS:
        assert np.array_equal(getattr(fa, k), getattr(again, k))


def test_save_load_roundtrip(tmp_path, fitted):
    X, y, fa, model = fitted
    p = str(tmp_path / "forest.npz")
    fa.save(p)
    fa2 = ForestArrays.load(p)
    assert np.array_equal(_bits(predict_proba(fa, X)),
                          _bits(predict_proba(fa2, X)))


def test_fixture_npz_equals_joblib():
    """The committed .npz, loaded by the port, equals the .joblib converted
    by the JAX package's from_sklearn and by the port's: the same arrays,
    and the same probabilities bit for bit."""
    import joblib
    model = joblib.load(FIXTURE + ".joblib")
    npz = port_score.load_model(FIXTURE + ".npz")
    ref = ref_forest.ForestArrays.from_sklearn(model)
    port = port_score.load_model(FIXTURE + ".joblib")
    assert (npz.feature.shape, npz.max_depth) == ((8, 105), 6)
    for fa in (ref, port):
        assert fa.max_depth == npz.max_depth
        for k in ARRAYS:
            a, b = getattr(npz, k), getattr(fa, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    X = _rows(npz, 4096, seed=5)
    p = [_bits(predict_proba(fa, X)) for fa in (npz, ref, port)]
    assert np.array_equal(p[0], p[1]) and np.array_equal(p[0], p[2])
    assert np.allclose(model.predict_proba(X)[:, 1], p[0].view(np.float32),
                       atol=1e-5)


def _feature_csvs(d, n_rows, n_meta, seed):
    """Feature CSVs of one sample and the combined sample (as in
    tests/test_scoring.py): 51 tab-separated columns, count2 = 1."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n_rows, 51))
    for i in range(2):
        with open(os.path.join(d, "%d.trstFeature.csv" % i), "w") as fh:
            for r in range(n_rows):
                cols = ["t%d.%d" % (i, r), "m%d" % (r % n_meta), "chr1"]
                vals = rows[r, 3:].tolist()
                cols += ["%.3f" % abs(v) for v in vals[:5]]
                cols += ["1"]
                cols += ["%.3f" % abs(v) for v in vals[6:]]
                fh.write("\t".join(cols[:51]) + "\n")


def test_score_cli(tmp_path):
    _feature_csvs(str(tmp_path), 20, 5, seed=1)
    out = {}
    for name, mod in (("port", port_score), ("ref", ref_score)):
        out[name] = str(tmp_path / ("%s.csv" % name))
        mod.score(str(tmp_path), FIXTURE + ".joblib", 1, out[name],
                  prob_score=0.0)
    lines = open(out["port"]).read().strip().split("\n")
    assert lines[0] == "meta_tid,y_prob_mean"
    assert len(lines) == 6   # header + 5 meta tids
    assert open(out["port"], "rb").read() == open(out["ref"], "rb").read()


def _score_cli(module, in_dir, model, count, out, env, *extra):
    subprocess.run([sys.executable, "-m", module, "-i", in_dir, "-m", model,
                    "-c", str(count), "-o", out, *extra], cwd=REPO, env=env,
                   check=True, timeout=300)
    with open(out, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("model", [".npz", ".joblib"])
def test_score_cli_device_path_matches_reference(tmp_path, model):
    """600 rows a file, so the port's forest runs its torch path; the
    reference CLI runs with jax blocked, so its forest falls back to
    numpy: the same bytes, threshold 0.0 and the default 0.2."""
    d = str(tmp_path / "csv")
    os.makedirs(d)
    _feature_csvs(d, 600, 97, seed=2)
    port_env = blocked_env(str(tmp_path / "shim_port"))
    ref_env = blocked_env(str(tmp_path / "shim_ref"), blocked=("jax",))
    for p in (["-p", "0.0"], []):
        got = _score_cli("aletsch_tpu_torch.scoring.score", d,
                         FIXTURE + model, 1, str(tmp_path / "port.csv"),
                         port_env, *p)
        want = _score_cli("aletsch_tpu.scoring.score", d, FIXTURE + model, 1,
                          str(tmp_path / "ref.csv"), ref_env, *p)
        assert got == want
        if p:
            assert got.count(b"\n") == 98    # header + 97 meta tids


def test_score_cli_on_an_assembled_cohort(tmp_path):
    """The score CLIs on the feature CSVs of a simulated two-sample cohort
    (the cohort of tests/test_scoring_reference.py) with the fixture
    model: the same bytes."""
    gtf = ref_tests._cohort_csvs(tmp_path)
    env = blocked_env(str(tmp_path / "shim"))
    got = _score_cli("aletsch_tpu_torch.scoring.score", gtf,
                     FIXTURE + ".npz", 2, str(tmp_path / "port.csv"), env,
                     "-p", "0.0")
    want = _score_cli("aletsch_tpu.scoring.score", gtf, FIXTURE + ".joblib",
                      2, str(tmp_path / "ref.csv"),
                      dict(os.environ, PYTHONPATH=REPO), "-p", "0.0")
    assert got == want and got.count(b"\n") > 1


def test_score_cli_reports_a_missing_model(tmp_path, capsys):
    assert port_score.main(["-i", str(tmp_path), "-m",
                            str(tmp_path / "none.npz"), "-c", "1", "-o",
                            str(tmp_path / "s.csv")]) == 1
    assert "cannot load model" in capsys.readouterr().err


def test_train_cli_matches_reference(tmp_path):
    """The port's train CLI on a cohort the port assembled gives the JAX
    package's model (its .npz arrays), and the port's score CLI with it
    the reference's bytes."""
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.meta.incubator import Incubator
    from test_train_score import build_training_cohort
    bl, truth_gtf = build_training_cohort(tmp_path)
    out_gtf, out_dir = str(tmp_path / "meta.gtf"), str(tmp_path / "gtf")
    os.makedirs(out_dir)
    params = default_params()
    for p in params:
        p.input_bam_list, p.output_gtf_file = bl, out_gtf
        p.output_gtf_dir, p.verbose = out_dir, 0
    Incubator(params).resolve()
    env = blocked_env(str(tmp_path / "shim"))
    models = {}
    for name, module, e in (
            ("port", "aletsch_tpu_torch.scoring.train", env),
            ("ref", "aletsch_tpu.scoring.train",
             dict(os.environ, PYTHONPATH=REPO))):
        models[name] = str(tmp_path / ("%s.npz" % name))
        subprocess.run([sys.executable, "-m", module, "-i", out_dir, "-g",
                        out_gtf, "-t", truth_gtf, "-c", "2", "-o",
                        models[name], "--n_estimators", "20",
                        "--max_depth", "8"],
                       cwd=REPO, env=e, check=True, timeout=300,
                       stdout=subprocess.DEVNULL)
    a = port_forest.ForestArrays.load(models["port"])
    b = ref_forest.ForestArrays.load(models["ref"])
    assert a.max_depth == b.max_depth
    for k in ARRAYS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    X, y, _ = port_train.label_rows(out_dir, out_gtf, truth_gtf, 2)
    Xr, yr, _ = ref_train.label_rows(out_dir, out_gtf, truth_gtf, 2)
    assert np.array_equal(X, Xr) and np.array_equal(y, yr)
    got = _score_cli("aletsch_tpu_torch.scoring.score", out_dir,
                     models["port"], 2, str(tmp_path / "port.csv"), env,
                     "-p", "0.0")
    want = _score_cli("aletsch_tpu.scoring.score", out_dir, models["ref"],
                      2, str(tmp_path / "ref.csv"),
                      dict(os.environ, PYTHONPATH=REPO), "-p", "0.0")
    assert got == want and got.count(b"\n") >= 6


def test_train_refuses_single_class_labels(tmp_path, capsys):
    """Feature rows whose transcripts match no truth chain: one class."""
    _feature_csvs(str(tmp_path), 20, 5, seed=3)
    (tmp_path / "empty.gtf").write_text("")
    rc = port_train.main(["-i", str(tmp_path), "-g",
                          str(tmp_path / "empty.gtf"), "-t",
                          str(tmp_path / "empty.gtf"), "-c", "1", "-o",
                          str(tmp_path / "m.npz")])
    assert rc == 1
    assert "single-class" in capsys.readouterr().err


@pytest.mark.skipif(not os.path.exists(ref_tests.REF_SCORE),
                    reason="reference score.py not present")
def test_reference_score_py_agreement(tmp_path):
    """The upstream score.py and the port's CLI on the same CSVs and the
    same model: the same transcripts, probabilities within 1e-6 (f32
    against sklearn's f64)."""
    gtf = ref_tests._cohort_csvs(tmp_path)
    env = blocked_env(str(tmp_path / "shim"))
    ref_out = str(tmp_path / "ref_scores.csv")
    subprocess.run([sys.executable, ref_tests.REF_SCORE, "-i", gtf, "-m",
                    ref_tests.MODEL, "-c", "2", "-o", ref_out, "-p", "0.0"],
                   check=True, env=dict(os.environ, PYTHONPATH=REPO),
                   cwd=str(tmp_path), stdout=subprocess.DEVNULL)
    our_out = str(tmp_path / "our_scores.csv")
    _score_cli("aletsch_tpu_torch.scoring.score", gtf, FIXTURE + ".npz", 2,
               our_out, env, "-p", "0.0")
    ref = ref_tests._read_scores(ref_out)
    ours = ref_tests._read_scores(our_out)
    assert ref and set(ref) == set(ours)
    for k in ref:
        assert abs(ref[k] - ours[k]) < 1e-6, (k, ref[k], ours[k])


@pytest.mark.skipif(not os.path.exists(ref_tests.REF_SCORE),
                    reason="reference score.py not present")
def test_reference_score_py_threshold_agreement(tmp_path):
    """Default 0.2 threshold: the kept sets agree too."""
    gtf = ref_tests._cohort_csvs(tmp_path)
    env = blocked_env(str(tmp_path / "shim"))
    ref_out = str(tmp_path / "ref_t.csv")
    subprocess.run([sys.executable, ref_tests.REF_SCORE, "-i", gtf, "-m",
                    ref_tests.MODEL, "-c", "2", "-o", ref_out],
                   check=True, env=dict(os.environ, PYTHONPATH=REPO),
                   cwd=str(tmp_path), stdout=subprocess.DEVNULL)
    our_out = str(tmp_path / "our_t.csv")
    _score_cli("aletsch_tpu_torch.scoring.score", gtf, FIXTURE + ".npz", 2,
               our_out, env)
    assert set(ref_tests._read_scores(ref_out)) == \
        set(ref_tests._read_scores(our_out))
