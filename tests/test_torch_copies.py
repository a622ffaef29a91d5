"""The port's own copies of the JAX-free modules (``config/``, ``data/``,
``server.py``) against the JAX package's: every shipped YAML gives the same
config tree, the same seed gives the same synthetic dataset and the same
train and eval batches array for array, and the HTTP front answers alike.
"""

import glob
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

import textreid_tpu.config as jax_config
import textreid_tpu.data as jax_data
import textreid_tpu.server as jax_server
import textreid_torch.config as port_config
import textreid_torch.data as port_data
import textreid_torch.server as port_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))


def test_every_yaml_is_listed():
    assert len(YAMLS) >= 11


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: "/".join(
    p.split(os.sep)[-2:]))
def test_yaml_loads_to_the_same_tree(path):
    trees = []
    for package in (jax_config, port_config):
        cfg = package.get_default_cfg()
        cfg.merge_from_file(path)
        cfg.merge_from_list(["SOLVER.BASE_LR", "0.5", "TPU.REMAT", "True"])
        cfg.freeze()
        trees.append(cfg)
    assert trees[0].dump() == trees[1].dump()
    assert str(trees[0]) == str(trees[1])


@pytest.mark.parametrize("variant,fused", [("", False), ("vit", True),
                                           ("fullclip", False)])
def test_flagship_configs_and_batch_match(variant, fused):
    want = jax_config.flagship_cfg(variant, fused_attention=fused)
    got = port_config.flagship_cfg(variant, fused_attention=fused)
    assert got.dump() == want.dump()
    a = jax_config.flagship_batch(4, 40, seed=3)
    b = port_config.flagship_batch(4, 40, seed=3)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_catalog_matches():
    for name in jax_config.DatasetCatalog.DATASETS:
        assert (port_config.DatasetCatalog.get("/r", name)
                == jax_config.DatasetCatalog.get("/r", name))
    with pytest.raises(RuntimeError, match="not available"):
        port_config.DatasetCatalog.get("/r", "nope_train")


def _workspace(package, root, split):
    package.make_synthetic_dataset(
        str(root / "datasets" / "cuhkpedes"), num_identities=6,
        images_per_id=4, image_size=(40, 20), vocab_size=50, max_tokens=12,
        seed=3, split=split)


def _cfg(package, root):
    cfg = package.get_default_cfg()
    cfg.merge_from_list([
        "ROOT", str(root), "DATASETS.TRAIN", "('cuhkpedes_train',)",
        "DATASETS.TEST", "('cuhkpedes_test',)", "INPUT.HEIGHT", "32",
        "INPUT.WIDTH", "16", "INPUT.MAX_TEXT_LENGTH", "14", "INPUT.USE_AUG",
        "True", "SOLVER.IMS_PER_BATCH", "8", "TEST.IMS_PER_BATCH", "5",
        "DATALOADER.NUM_WORKERS", "2"])
    cfg.freeze()
    return cfg


def test_synthetic_dataset_and_batches_match(tmp_path):
    roots = tmp_path / "jax", tmp_path / "port"
    for package, root in zip((jax_data, port_data), roots):
        for split in ("train", "test"):
            _workspace(package, root, split)
    for split in ("train", "test"):
        files = [r / "datasets" / "cuhkpedes" / "annotations" / f"{split}.json"
                 for r in roots]
        assert json.loads(files[0].read_text()) == json.loads(
            files[1].read_text())

    cfgs = (_cfg(jax_config, roots[0]), _cfg(port_config, roots[1]))
    train = [next(iter(pkg.make_data_loader(cfg, is_train=True, seed=11)))
             for pkg, cfg in zip((jax_data, port_data), cfgs)]
    evals = [list(pkg.make_data_loader(cfg, is_train=False)[0])
             for pkg, cfg in zip((jax_data, port_data), cfgs)]
    assert len(evals[0]) == len(evals[1]) == 5  # 24 samples at batch 5
    for a, b in [train] + list(zip(*evals)):
        assert set(a) == set(b) and "pixels" in a
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert train[0]["pixels"].dtype == np.uint8  # device_prep batches
    assert not evals[0][-1]["valid"].all()  # the padded last eval batch


class _Index:
    """A stand-in index: scores by token sum, so replies are predictable."""
    gallery = np.zeros((7, 4), np.float32)
    gallery_meta = np.arange(100, 107)

    def search(self, token_ids, lengths, k=10):
        base = token_ids.sum(axis=1, keepdims=True).astype(np.float32)
        scores = base - np.arange(k, dtype=np.float32)[None, :]
        meta = np.tile(self.gallery_meta[np.arange(k) % 7], (len(base), 1))
        return scores, meta


@pytest.mark.parametrize("package", [jax_server, port_server],
                         ids=["jax", "port"])
def test_http_front_answers_alike(package):
    service = package.RetrievalService(_Index(), max_text_length=6,
                                       k_buckets=[5, 10])
    server = package.make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        body = json.dumps({"token_ids": [[1, 2, 3], [4]], "k": 3}).encode()
        with urllib.request.urlopen(base + "/search", data=body,
                                    timeout=30) as resp:
            reply = json.loads(resp.read())
        assert reply["scores"] == [[6.0, 5.0, 4.0], [4.0, 3.0, 2.0]]
        assert reply["meta"] == [[100, 101, 102]] * 2
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["gallery_rows"] == 7
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/search", data=json.dumps(
                {"token_ids": [[1]], "k": 11}).encode(), timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
