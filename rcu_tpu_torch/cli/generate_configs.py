"""Generate the full config family (66 yamls) for both datasets and all 8
uncertainty strategies: train and test, 10 ensemble members, 5-fold CV
(``scripts/generate_configs.py`` counterpart; the same files, byte for
byte). ``yaml`` is imported by the function that writes.

  python -m rcu_tpu_torch.cli.generate_configs [out_dir]   # default config/
"""
import argparse
import os

from rcu_tpu_torch import directories as dirs

BRATS_H5 = "in/datasets/brats18_train_reduced_norm.h5"
BRATS_TEST_H5 = "in/datasets/brats18_test_reduced_norm.h5"
BRATS_WPRED_H5 = "in/datasets/brats18_train_wpred_reduced_norm.h5"
BRATS_TEST_WPRED_H5 = "in/datasets/brats18_test_wpred_reduced_norm.h5"
ISIC_TRAIN = "in/datasets/isic_small/ISIC-2017_Training"
ISIC_VALID = "in/datasets/isic_small/ISIC-2017_Validation"
ISIC_TEST = "in/datasets/isic_small/ISIC-2017_Test_v2"

SPLIT_BRATS = "config/splits/split_brats18_100-25-160.json"
SPLIT_BRATS_K10 = "config/splits/split_brats18_k10_90-25-160.json"
SPLIT_BRATS_CV = "config/splits/split_brats18_cv_k5_100-25-25.json"
SPLIT_ISIC_CV = "config/splits/split_isic_cv_k5_1600-400-400.json"
SPLIT_ISIC_K10 = "config/splits/split_isic-train_k10_1800-0-0.json"


def unet(in_channels, dropout=0.05, center=None, sigma=False):
    m = {"depth": 4, "dropout": dropout, "in_channels": in_channels,
         "nb_classes": 2, "start_filters": 32}
    if center is not None:
        m["dropout_center"] = center
    if sigma:
        m["sigma_out"] = True
    return {"unet": m}


def brats_train_data(dataset=BRATS_H5, batch_size=32):
    return {"batch_size": batch_size, "dataset": dataset,
            "indexing": {"slice": {}},
            "selection_strategy": {"none-black": {}},
            "selection_extractor": {"data": {"categories": ["images"]}},
            "num_workers": 1, "shuffle": True}


def brats_valid_data(dataset=BRATS_H5, batch_size=32):
    return {"batch_size": batch_size, "dataset": dataset,
            "indexing": {"slice": {}}, "num_workers": 0, "shuffle": False}


def isic_data(dataset, shuffle):
    return {"batch_size": 32, "dataset": dataset, "num_workers": 1 if shuffle else 0,
            "shuffle": shuffle,
            "transform": [{"rescale": {"entries": ["images", "labels"],
                                       "lower": 0, "upper": 1}}]}


def train_cfg(name, train_dir, split, epochs, model, others, train_data,
              valid_data, seed=20):
    return {"config": {
        "train_name": name, "train_dir": train_dir, "split": split,
        "epochs": epochs, "model": model,
        "optimizer": {"adam": {"lr": 0.0001}},
        "seed": seed, "valid_every_nth": 1, "log_every_nth": 10,
        "others": others, "train_data": train_data, "valid_data": valid_data,
    }, "meta": {"type": "train-config", "version": 0}}


def test_cfg(name, test_dir, split, others, test_data, test_at="best", seed=20):
    return {"config": {
        "test_name": name, "test_dir": test_dir,
        "model_dir": None,  # user fills: out/<ds>/<ts>_<name>/model_<ts>
        "split": split, "seed": seed, "test_at": test_at,
        "others": others, "test_data": test_data,
    }, "meta": {"type": "test-config", "version": 0}}


def write_yaml(full, cfg):
    import yaml
    os.makedirs(os.path.dirname(full), exist_ok=True)
    with open(full, "w") as f:
        yaml.safe_dump(cfg, f, default_flow_style=False, sort_keys=False)


def main(out_dir: str = None):
    """Write the 66 yamls under ``out_dir`` (default the config dir);
    returns their count."""
    out_dir = out_dir or dirs.CONFIG_DIR

    def write(path, cfg):
        write_yaml(os.path.join(out_dir, path), cfg)

    # ----------------------------------------------------------- BraTS train
    write("train_brats_baseline.yaml", train_cfg(
        "brats_baseline", "out/brats", SPLIT_BRATS, 50, unet(4), {},
        brats_train_data(), brats_valid_data(batch_size=10)))
    write("train_brats_center.yaml", train_cfg(
        "brats_center", "out/brats", SPLIT_BRATS, 50, unet(4, 0.5, center=4), {},
        brats_train_data(), brats_valid_data()))
    write("train_brats_aleatoric.yaml", train_cfg(
        "brats_aleatoric", "out/brats", SPLIT_BRATS, 50, unet(4, sigma=True),
        {"is_log_sigma": False}, brats_train_data(), brats_valid_data()))
    write("train_brats_auxiliary_feat.yaml", train_cfg(
        "brats_auxiliary_feat", "out/brats", SPLIT_BRATS, 100,
        {"postnet": {"in_channels": 32, "nb_classes": 2}},
        {"model_dir": None, "test_at": "best"},
        brats_train_data(), brats_valid_data()))
    write("train_brats_auxiliary_segm.yaml", train_cfg(
        "brats_auxiliary_segm", "out/brats", SPLIT_BRATS, 50, unet(5), {},
        brats_train_data(BRATS_WPRED_H5), brats_valid_data(BRATS_WPRED_H5)))
    for k in range(10):
        write(f"train_ensemble/train_brats_ensemble_{k}.yaml", train_cfg(
            f"brats_ensemble_k{k}", "out/brats", SPLIT_BRATS_K10, 100, unet(4),
            {"split_k": k}, brats_train_data(), brats_valid_data()))
    for k in range(5):
        write(f"baseline_cv/train_brats_baseline_cv{k}.yaml", train_cfg(
            f"brats_baseline_cv{k}", "out/brats", SPLIT_BRATS_CV, 100, unet(4),
            {"split_k": k}, brats_train_data(), brats_valid_data()))

    # ----------------------------------------------------------- BraTS test
    def brats_test(name, others=None, dataset=BRATS_TEST_H5, test_at="best",
                   split=SPLIT_BRATS):
        return test_cfg(name, "out/predictions/brats", split, others or {},
                        brats_valid_data(dataset), test_at)

    write("test_brats_baseline.yaml", brats_test("brats_test_baseline"))
    write("test_brats_baseline_mc.yaml", brats_test("brats_test_baseline_mc",
                                                    {"mc": 20}))
    write("test_brats_center.yaml", brats_test("brats_test_center"))
    write("test_brats_center_mc.yaml", brats_test("brats_test_center_mc",
                                                  {"mc": 20}))
    write("test_brats_aleatoric.yaml", brats_test("brats_test_aleatoric",
                                                  {"is_log_sigma": False}))
    write("test_brats_auxiliary_feat.yaml", brats_test(
        "brats_test_auxiliary_feat", {"model_dir": None, "test_at": "best"}))
    write("test_brats_auxiliary_segm.yaml", brats_test(
        "brats_test_auxiliary_segm", dataset=BRATS_TEST_WPRED_H5))
    write("test_brats_ensemble.yaml", brats_test(
        "brats_test_ensemble", {"model_dir": [], "test_at": "best"}))
    for k in range(5):
        write(f"baseline_cv/test_brats_baseline_cv{k}.yaml", brats_test(
            f"brats_test_baseline_cv{k}", {"split_k": k}, dataset=BRATS_H5,
            split=SPLIT_BRATS_CV))

    # ----------------------------------------------------------- ISIC train
    def isic_train(name, epochs, model, others=None, split="", train=ISIC_TRAIN,
                   valid=ISIC_VALID):
        return train_cfg(name, "out/isic", split, epochs, model, others or {},
                         isic_data(train, True), isic_data(valid, False))

    write("train_isic_baseline.yaml", isic_train("isic_baseline", 100, unet(3)))
    write("train_isic_center.yaml", isic_train("isic_center", 100,
                                               unet(3, 0.5, center=4)))
    write("train_isic_aleatoric.yaml", isic_train(
        "isic_aleatoric", 100, unet(3, sigma=True), {"is_log_sigma": False}))
    write("train_isic_auxiliary_feat.yaml", isic_train(
        "isic_auxiliary_feat", 100, {"postnet": {"in_channels": 32, "nb_classes": 2}},
        {"model_dir": None, "test_at": "best"}))
    write("train_isic_auxiliary_segm.yaml", isic_train(
        "isic_auxiliary_segm", 100, unet(4),
        {"prediction_dir": None, "split_k": 0}, split=SPLIT_ISIC_CV,
        valid=ISIC_TRAIN))
    for k in range(10):
        write(f"train_ensemble/train_isic_ensemble_{k}.yaml", isic_train(
            f"isic_ensemble_k{k}", 100, unet(3),
            {"split_k": k}, split=SPLIT_ISIC_K10))
    for k in range(5):
        write(f"baseline_cv/train_isic_baseline_cv{k}.yaml", isic_train(
            f"isic_baseline_cv{k}", 100, unet(3), {"split_k": k},
            split=SPLIT_ISIC_CV, valid=ISIC_TRAIN))

    # ----------------------------------------------------------- ISIC test
    def isic_test(name, others=None, test_at="best", split="", dataset=ISIC_TEST):
        return test_cfg(name, "out/predictions/isic", split, others or {},
                        isic_data(dataset, False), test_at)

    write("test_isic_baseline.yaml", isic_test("isic_test_baseline"))
    write("test_isic_baseline_mc.yaml", isic_test("isic_test_baseline_mc",
                                                  {"mc": 20}))
    write("test_isic_center.yaml", isic_test("isic_test_center"))
    write("test_isic_center_mc.yaml", isic_test("isic_test_center_mc", {"mc": 20}))
    write("test_isic_aleatoric.yaml", isic_test("isic_test_aleatoric",
                                                {"is_log_sigma": False}))
    write("test_isic_auxiliary_feat.yaml", isic_test(
        "isic_test_auxiliary_feat", {"model_dir": None, "test_at": "best"}))
    write("test_isic_auxiliary_segm.yaml", isic_test(
        "isic_test_auxiliary_segm", {"prediction_dir": None}, test_at="last"))
    write("test_isic_ensemble.yaml", isic_test(
        "isic_test_ensemble", {"model_dir": [], "test_at": "best"}))
    for k in range(5):
        write(f"baseline_cv/test_isic_baseline_cv{k}.yaml", isic_test(
            f"isic_test_baseline_cv{k}", {"split_k": k}, split=SPLIT_ISIC_CV,
            dataset=ISIC_TRAIN))

    count = sum(len([f for f in files if f.endswith(".yaml")])
                for root, _, files in os.walk(out_dir)
                if not root.endswith("splits"))
    print(f"wrote {count} config yamls under {out_dir}")
    return count


def cli():
    parser = argparse.ArgumentParser(description="write the config yamls")
    parser.add_argument("out_dir", nargs="?", default=None,
                        help="output directory (default: the config dir)")
    main(parser.parse_args().out_dir)


if __name__ == "__main__":
    cli()
