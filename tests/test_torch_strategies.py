"""The four strategy families of the port's direct eval against
``rcu_tpu.eval.direct``: aleatoric (log-sigma and sigma heads), ensemble,
auxiliary_feat and auxiliary_segm, on the same H5 stores (with raw-t2
NIfTIs for the mask), split, yaml configs and flax checkpoints written by
the JAX checkpoint service.

The same CSV files must come out, with the suffixed result ids and the
minmax confidence entry: integer and boolean cells exactly, floats at rtol
1e-4. The weights are chosen with a margin on each family's planes (no
rescaled confidence near a threshold, no folded or fg value near a bin
edge, no prediction near a tie), where a 1-ulp difference between the
frameworks would flip a count.
"""
import jax
import numpy as np
import pytest
import yaml

from rcu_tpu.data import h5
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_direct import SHAPE, _cell_equal, make_store, read_dir
from tests.test_torch_unet import flax_net

UNET = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
            dropout=0.2)
THRESHOLDS = np.float32(port_direct.DEFAULT_THRESHOLDS)
EDGES = np.arange(1, 10) / 10.0  # 0.5 among them: the fg > 0.5 decision
# a fold lies below 0.5 where the prediction is 0 and above it elsewhere,
# so only the prediction can move it across 0.5 (the run's largest
# rescaled value folds to 0.5 - eps/2 exactly in both frameworks)
FOLD_EDGES = EDGES[EDGES != 0.5]
MARGIN = 1e-5
EPS = 1e-5
TEST_SUBJECTS = ("s02", "s03")


def write_model(model_dir, model_type, record, params, stats):
    mf = jax_ckpt.ModelFiles.from_model_dir(str(model_dir))
    jax_ckpt.backup_model_parameters(
        mf, jax_cfg.ParametricNode(model_type, record), None)
    jax_ckpt.save_checkpoint(mf, {"params": params, "batch_stats": stats,
                                  "epoch": 1, "best_score": 0.5},
                             epoch=1, best=True)
    return str(model_dir)


def write_config(path, name, model_dir, split_file, store, others):
    with open(path, "w") as f:
        yaml.safe_dump({"config": {
            "test_name": name, "model_dir": model_dir, "split": split_file,
            "seed": 20, "test_at": "best", "others": others,
            "test_data": {"batch_size": 2, "dataset": store,
                          "indexing": {"slice": {}}, "shuffle": False}},
            "meta": {"type": "test-config", "version": 0}}, f)
    return str(path)


def make_wpred_store(tmp_path, store):
    """The store's subjects with [gt, baseline prediction] labels; the
    baseline misses a block of the lesion and adds a false one."""
    path = str(tmp_path / "wpred.h5")
    src = h5.SubjectDataset(store)
    with h5.DatasetWriter(path) as w:
        for s in src.subjects:
            gt = np.asarray(src.read_volume(s, "labels"))
            baseline = gt.copy()
            baseline[:, 4:7, 5:8] = 0
            baseline[:, 12:14, 14:17] = 1
            w.add_subject(s, {"images": np.asarray(src.read_volume(s, "images")),
                              "labels": np.stack([gt, baseline], axis=-1)},
                          props=ImageProperties(size=gt.shape[::-1]),
                          files=src.files(s))
    src.close()
    return path


def read_test_volumes(store):
    """The test subjects' images (Z, H, W, 4) and labels."""
    reader = h5.SubjectDataset(store)
    out = [(np.asarray(reader.read_volume(s, "images")),
            np.asarray(reader.read_volume(s, "labels"))) for s in TEST_SUBJECTS]
    reader.close()
    return out


def gap(values, points):
    """The least distance of any value to any point."""
    values = np.asarray(values, np.float64).reshape(-1, 1)
    return float(np.abs(values - np.asarray(points, np.float64)).min())


def softmax(logits):
    return np.asarray(jax.nn.softmax(logits, -1))


def rescale(x, lo, hi):
    return (x - lo) / (hi - lo) * np.float32(1 - 2 * EPS) + np.float32(EPS)


def fold(u, prediction):
    return np.where(prediction == 1, 1 - u / 2, u / 2)


def apply(fm, params, stats, x):
    return fm.apply({"params": params, "batch_stats": stats}, x)


def spread_head(fm, params, stats, x, key, std=2.0):
    """Scale and shift the class conv ``key`` so that the logit difference
    on ``x`` has median 0 and standard deviation ``std``: random weights
    give near-constant maps, which would fill one bin."""
    logits = np.asarray(apply(fm, params, stats, x).logits, np.float64)
    diff = logits[..., 1] - logits[..., 0]
    scale = std / diff.std()
    head = {k: np.float32(scale) * v for k, v in params[key].items()}
    head["bias"] = head["bias"] - np.float32([0.0, scale * np.median(diff)])
    return {**params, key: head}


def bins_hit(plane):
    """How many of the 10 reliability bins the plane fills."""
    return int((np.histogram(plane, bins=10, range=(0, 1))[0] > 0).sum())


def confidence_gaps(confidences, predictions):
    """Subject rescale and fold of each subject's map: their gaps to the
    thresholds and to the bin edges; 0 where a fold fills fewer than 4
    bins."""
    gaps = []
    for conf, pred in zip(confidences, predictions):
        resc = rescale(conf, conf.min(), conf.max())
        folded = fold(resc, pred)
        gaps += [gap(resc, THRESHOLDS), gap(folded, FOLD_EDGES),
                 float(bins_hit(folded) >= 4)]
    return min(gaps)


def search(candidate, what):
    """The first seed whose weights keep every plane MARGIN away from
    where a count could flip; ``candidate(seed)`` -> (gap, weights)."""
    for seed in range(60):
        margin, weights = candidate(seed)
        if margin > MARGIN:
            return weights
    raise AssertionError(f"no {what} weights with the margin")


def aleatoric_weights(volumes, is_log_sigma):
    x = np.concatenate([v for v, _ in volumes])
    params = {**UNET, "sigma_out": True}

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, SHAPE[1:], seed=100 + seed)
        p = spread_head(fm, p, stats, x, "Conv_2")
        # sigma above 0.5: near 0, |sigma| would hold a run minimum whose
        # relative error is that of a difference of nearly equal numbers
        low = float(np.asarray(apply(fm, p, stats, x).sigma).min())
        p = {**p, "Conv_3": {**p["Conv_3"], "bias": p["Conv_3"]["bias"]
                             + np.float32(0.5 - low)}}
        out = apply(fm, p, stats, x)
        probs = softmax(out.logits)
        pred = probs.argmax(-1)
        sigma = np.exp(out.sigma) if is_log_sigma else np.abs(out.sigma)
        sigma = np.take_along_axis(np.asarray(sigma), pred[..., None], -1)[..., 0]
        resc = rescale(sigma, sigma.min(), sigma.max())
        margin = min(gap(resc, THRESHOLDS), gap(fold(resc, pred), FOLD_EDGES),
                     float(np.abs(probs[..., 1] - probs[..., 0]).min()))
        return margin if bins_hit(fold(resc, pred)) >= 4 else 0.0, \
            (params, p, stats)

    return search(candidate, "aleatoric")


def ensemble_weights(volumes, n_members=3):
    x = np.concatenate([v for v, _ in volumes])

    def candidate(seed):
        members, total = [], 0.0
        for k in range(n_members):
            fm, p, stats = flax_net("unet", UNET, SHAPE[1:],
                                    seed=200 + 10 * seed + k)
            p = spread_head(fm, p, stats, x, "Conv_2")
            total = total + softmax(apply(fm, p, stats, x).logits)
            members.append((p, stats))
        probs = total / n_members
        ent = -(probs * np.log(probs)).sum(-1) / np.log(2.0)
        margin = min(gap(probs[..., 1], EDGES), gap(ent, THRESHOLDS))
        return margin if bins_hit(probs[..., 1]) >= 4 else 0.0, members

    return search(candidate, "ensemble")


def aux_feat_weights(volumes):
    params = {**UNET, "provide_features": True}
    post = dict(nb_classes=2, in_channels=UNET["start_filters"])

    x = np.concatenate([v for v, _ in volumes])

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, SHAPE[1:], seed=300 + seed)
        p = spread_head(fm, p, stats, x, "Conv_2")
        fp, pp, pstats = flax_net("postnet", post, SHAPE[1:], seed=400 + seed)
        pp = spread_head(fp, pp, pstats, apply(fm, p, stats, x).features,
                         "Conv_0")
        confs, preds, margin = [], [], np.inf
        for images, _ in volumes:
            out = apply(fm, p, stats, images)
            logits = np.asarray(out.logits)
            margin = min(margin, float(np.abs(logits[..., 1]
                                              - logits[..., 0]).min()))
            preds.append(logits.argmax(-1))
            confs.append(softmax(apply(fp, pp, pstats, out.features).logits)[..., 1])
        margin = min(margin, confidence_gaps(confs, preds))
        return margin, ((p, stats), (pp, pstats))

    return search(candidate, "auxiliary_feat")


def aux_segm_weights(volumes):
    params = {**UNET, "in_channels": 5}

    inputs = [np.concatenate([images, labels[..., 1:].astype(np.float32)],
                             axis=-1) for images, labels in volumes]

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, SHAPE[1:], seed=500 + seed)
        p = spread_head(fm, p, stats, np.concatenate(inputs), "Conv_2")
        confs = [softmax(apply(fm, p, stats, x).logits)[..., 1] for x in inputs]
        preds = [labels[..., 1] for _, labels in volumes]
        return confidence_gaps(confs, preds), (params, p, stats)

    return search(candidate, "auxiliary_segm")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """{family: config file} for the four families (aleatoric twice)."""
    tmp = tmp_path_factory.mktemp("torch_strategies")
    store = make_store(tmp)
    wpred = make_wpred_store(tmp, store)
    split_file = str(tmp / "split.json")
    save_split(split_file, ["s00"], ["s01"], list(TEST_SUBJECTS))
    volumes = read_test_volumes(store)
    configs = {}
    for is_log_sigma in (True, False):
        params, p, stats = aleatoric_weights(volumes, is_log_sigma)
        name = f"aleatoric_log{int(is_log_sigma)}"
        model_dir = write_model(tmp / name, "unet", params, p, stats)
        configs[name] = write_config(tmp / f"{name}.yaml", name, model_dir,
                                     split_file, store,
                                     {"is_log_sigma": is_log_sigma})
    dirs = [write_model(tmp / f"member{k}", "unet", UNET, p, stats)
            for k, (p, stats) in enumerate(ensemble_weights(volumes))]
    configs["ensemble"] = write_config(
        tmp / "ensemble.yaml", "ensemble", dirs[0], split_file, store,
        {"model_dir": dirs[1:], "test_at": "best"})
    (p, stats), (pp, pstats) = aux_feat_weights(volumes)
    segmenter = write_model(tmp / "segmenter", "unet", UNET, p, stats)
    # flax infers the PostNet's width: this model.json leaves it out
    postnet = write_model(tmp / "postnet", "postnet", {"nb_classes": 2},
                          pp, pstats)
    configs["auxiliary_feat"] = write_config(
        tmp / "aux_feat.yaml", "auxiliary_feat", postnet, split_file, store,
        {"model_dir": segmenter, "test_at": "best"})
    params, p, stats = aux_segm_weights(read_test_volumes(wpred))
    configs["auxiliary_segm"] = write_config(
        tmp / "aux_segm.yaml", "auxiliary_segm",
        write_model(tmp / "error_net", "unet", params, p, stats), split_file,
        wpred, {})
    return configs


def assert_same_csvs(want_dir, got_dir):
    want, got = read_dir(want_dir), read_dir(got_dir)
    assert got.keys() == want.keys()
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        assert got[name][0] == rows[0], name  # header
        for want_row, got_row in zip(rows[1:], got[name][1:]):
            for col, a, b in zip(rows[0], got_row, want_row):
                assert _cell_equal(a, b), (name, col, a, b)
    return want


@pytest.mark.parametrize("family,strategy,suffix,entry", [
    ("aleatoric_log1", "aleatoric", "_globalrescale", "sigma"),
    ("aleatoric_log0", "aleatoric", "_globalrescale", "sigma"),
    ("ensemble", "ensemble", "", "probabilities"),
    ("auxiliary_feat", "auxiliary_feat", "_rescale", "confidence"),
    ("auxiliary_segm", "auxiliary_segm", "_rescale", "confidence")])
def test_family_csvs_match_jax(env, tmp_path, family, strategy, suffix, entry):
    """``rcu_tpu.eval.direct`` is told the strategy; the port detects it."""
    config_file = env[family]
    jax_eces = jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                                   str(tmp_path / "jax"), run_id=family,
                                   strategy=strategy)
    plain = evalstats.fused_eval_stats.plain_calls
    port_eces = port_direct.evaluate_direct(port_cfg.load(config_file),
                                            str(tmp_path / "port"),
                                            run_id=family, device="cpu")
    # one eval kernel pass per subject (aleatoric: in its second pass)
    assert evalstats.fused_eval_stats.plain_calls == plain + 2
    assert jax_eces.keys() == port_eces.keys() == set(TEST_SUBJECTS)
    assert all(np.isfinite(e) for e in port_eces.values())
    csvs = assert_same_csvs(tmp_path / "jax", tmp_path / "port")
    assert len(csvs) == 14  # calibration, ece, minmax + 11 thresholds
    result_id = family + suffix
    assert f"eval_calibration_{result_id}.csv" in csvs
    assert f"eval_ece_{result_id}.csv" in csvs
    assert f"eval_uncertainty_{result_id}_th050.csv" in csvs
    minmax = csvs[f"eval_summary_minmax_{family}.csv"]
    assert minmax[0] == ["confidence_entry", "min", "max"]
    assert minmax[1][0] == entry
    ece_rows = csvs[f"eval_ece_{result_id}.csv"]
    assert [r[0] for r in ece_rows[1:]] == [result_id] * 2
    # the planes spread over the bins and the counts say something
    bins = csvs[f"eval_calibration_{result_id}.csv"]
    counts = [int(c) for c in bins[1][2:12]]
    assert sum(c > 0 for c in counts) >= 3, counts
