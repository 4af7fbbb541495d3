"""Inside the port: the staged chain (``strategies.test_*`` -> NIfTI
artifacts -> the offline engine of ``eval.actions``) against the direct
eval in ``layout="eval_tree"`` on the same checkpoints and subjects, for
the deterministic families (baseline, ensemble, aleatoric,
auxiliary_feat, auxiliary_segm): the same CSV files in the same tree,
integer and boolean cells exact and floats at rtol 1e-4
(``tests/test_direct_vs_staged.py`` holds the same for the JAX package).

The two paths differ where they may: the loader's batches cross subject
bounds, the staged engine rebuilds the background class as ``1 - fg``
and takes the argmax of the probabilities where the direct eval compares
``fg > 0.5`` or takes the argmax of the logits. So the weights are those
of ``tests/test_torch_strategies.py``'s search, whose planes keep a
margin from every bin edge, threshold and argmax tie."""
import os

import numpy as np
import pytest

from rcu_tpu.data import h5, nifti
from rcu_tpu.data.split import save_split
from rcu_tpu_torch import strategies
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import actions, analysis, evaldata
from rcu_tpu_torch.eval.direct import evaluate_direct
from tests.test_torch_direct import make_store
from tests.test_torch_eval_engine import ACTIONS, assert_same_tree
from tests.test_torch_strategies import (TEST_SUBJECTS, UNET,
                                         aleatoric_weights, aux_feat_weights,
                                         aux_segm_weights, ensemble_weights,
                                         make_wpred_store, read_test_volumes,
                                         write_config, write_model)

SPLIT_NAME = "split_brats18_100-25-160.json"


def gt_tree(root, store):
    """The store's subjects in the BraTS raw layout: its ground truth as
    ``_seg``, its raw t2 (the foreground mask's source) as ``_t2``."""
    reader = h5.SubjectDataset(store)
    for s in reader.subjects:
        d = os.path.join(root, "HGG", s)
        os.makedirs(d)
        labels = np.asarray(reader.read_volume(s, "labels"))
        t2, _ = nifti.read(reader.files(s)["images"]["t2"])
        for entry in ("flair", "t1", "t1ce"):
            nifti.write(np.zeros_like(t2), os.path.join(d, f"{s}_{entry}.nii.gz"))
        nifti.write(t2, os.path.join(d, f"{s}_t2.nii.gz"))
        nifti.write(labels.astype(np.uint8), os.path.join(d, f"{s}_seg.nii.gz"))
    reader.close()
    return root


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_staged_vs_direct")
    store = make_store(tmp)
    wpred = make_wpred_store(tmp, store)
    (tmp / "splits").mkdir()
    split = str(tmp / "splits" / SPLIT_NAME)
    save_split(split, ["s00"], ["s01"], list(TEST_SUBJECTS))
    volumes = read_test_volumes(store)
    members = [write_model(tmp / f"member{k}", "unet", UNET, p, stats)
               for k, (p, stats) in enumerate(ensemble_weights(volumes))]
    ((p, stats),) = ensemble_weights(volumes, n_members=1)
    params, sp, sstats = aleatoric_weights(volumes, False)
    (fp, fstats), (pp, pstats) = aux_feat_weights(volumes)
    eparams, ep, estats = aux_segm_weights(read_test_volumes(wpred))

    def config(name, model_dir, others=None, dataset=store):
        return write_config(tmp / f"{name}.yaml", name, model_dir, split,
                            dataset, others or {})

    configs = {
        "baseline": config("baseline", write_model(
            tmp / "baseline", "unet", UNET, p, stats)),
        "ensemble": config("ensemble", members[0],
                           {"model_dir": members[1:], "test_at": "best"}),
        "aleatoric": config("aleatoric", write_model(
            tmp / "sigma", "unet", params, sp, sstats),
            {"is_log_sigma": False}),
        "auxiliary_feat": config("auxiliary_feat", write_model(
            tmp / "postnet", "postnet", {"nb_classes": 2}, pp, pstats),
            {"model_dir": write_model(tmp / "segmenter", "unet", UNET, fp,
                                      fstats), "test_at": "best"}),
        "auxiliary_segm": config("auxiliary_segm", write_model(
            tmp / "error_net", "unet", eparams, ep, estats), dataset=wpred),
    }
    return configs, gt_tree(str(tmp / "Training"), store), split


def staged_eval(run_dir, run_id, entry, eval_dir, gt_dir, split):
    """The offline engine over one run dir, as ``cli.eval_uncertainty``
    drives it: the minmax pass first, then the other three."""
    eval_data = evaldata.get_brats_data(
        evaldata.EvalData(run_id, run_dir, entry), in_dir=gt_dir,
        split_file=split)
    for names in (ACTIONS[:1], ACTIONS[1:]):
        passes = actions.get_actions(names, os.path.join(eval_dir, "minmax"),
                                     eval_dir, "foreground", device="cpu")
        for p in passes:
            p.setup_eval(eval_data)
            p.start_eval()
        for sf in eval_data.subject_files:
            loader = analysis.Loader()
            for p in passes:
                p.eval_subject(sf, loader)
        for p in passes:
            p.finish_eval()


FAMILIES = {"baseline": ("test_default", "probabilities"),
            "ensemble": ("test_ensemble", "probabilities"),
            "aleatoric": ("test_aleatoric", "sigma"),
            "auxiliary_feat": ("test_auxiliary_feat", "confidence"),
            "auxiliary_segm": ("test_auxiliary_segm", "confidence")}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_staged_chain_equals_direct_eval_tree(env, tmp_path, family):
    configs, gt_dir, split = env
    runner, entry = FAMILIES[family]
    config = port_cfg.load(configs[family])
    config.test_dir = str(tmp_path / "pred")
    loop = getattr(strategies, runner)(config, device="cpu")
    staged = str(tmp_path / "staged")
    staged_eval(loop.run_dir, family, entry, staged, gt_dir, split)
    direct = str(tmp_path / "direct")
    eces = evaluate_direct(port_cfg.load(configs[family]), direct,
                           run_id=family, mc=0, layout="eval_tree",
                           device="cpu")
    assert set(eces) == set(TEST_SUBJECTS)
    csvs = assert_same_tree(staged, direct, 14)
    assert sorted({name.split(os.sep)[0] for name in csvs}) == \
        ["calibration", "ece_foreground", "minmax", "uncertainty"]


def test_eval_tree_is_the_cli_flag_and_layouts_are_checked(env, tmp_path,
                                                         monkeypatch):
    from rcu_tpu_torch.cli import eval_direct as cli
    configs, _, _ = env
    seen = {}
    monkeypatch.setattr(cli, "main", lambda *args: seen.setdefault("args", args))
    monkeypatch.setattr("sys.argv", ["eval_direct", "-config_file",
                                     configs["baseline"], "-eval_tree"])
    cli.cli()
    assert seen["args"][7] is True  # eval_tree, after the strategy
    monkeypatch.undo()
    with pytest.raises(ValueError, match="unknown layout"):
        evaluate_direct(port_cfg.load(configs["baseline"]),
                        str(tmp_path / "x"), mc=0, layout="tree",
                        device="cpu")
