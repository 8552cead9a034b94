"""MLP estimate of the latent dimension k from NMFk statistics.

Port of ``pydnmfk_tpu/models/ml_recognition.py`` (reference
pyDNMFk/MLFeatureRecognition.py and the sklearn-MLP JSON of utils.py:393-460,
after "A neural network for determination of latent dimensionality in
non-negative matrix factorization"). The forward pass is numpy, from the
stored ``coefs_`` and ``intercepts_``; the statistics and the sliding-window
vote follow the reference (buildStatistics :35-69, predictStatistics
:72-100), each k's statistics read through ``utils/io.py::
read_cluster_results`` (results.h5 or results.npz). :func:`train_mlp` trains
a window classifier in PyTorch, on the CUDA card unless ``device="cpu"``,
and returns it in the same JSON-ready form, which the reference and the JAX
package load.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_PROPERTIES = ["minSilhouetteCoefficients", "AIC",
                      "avgSilhouetteCoefficients"]
ML_WINDOW = 7          # the pretrained model consumes 7-k windows

_ACTIVATIONS = {
    "relu": lambda x: np.maximum(x, 0.0),
    "tanh": np.tanh,
    "logistic": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "identity": lambda x: x,
}


class MLPModel:
    """Inference-only MLP in the reference's JSON form (keys coefs_,
    intercepts_, params.activation, out_activation_, classes_)."""

    def __init__(self, coefs: List[np.ndarray], intercepts: List[np.ndarray],
                 activation: str = "relu", out_activation: str = "softmax",
                 classes: Optional[np.ndarray] = None):
        self.coefs = [np.asarray(c, dtype=np.float64) for c in coefs]
        self.intercepts = [np.asarray(b, dtype=np.float64) for b in intercepts]
        self.activation = activation
        self.out_activation = out_activation
        self.classes = (np.arange(self.coefs[-1].shape[1])
                        if classes is None else np.asarray(classes))

    @classmethod
    def from_json(cls, path: str) -> "MLPModel":
        with open(path) as f:
            d = json.load(f)
        classes = d.get("classes_")
        return cls(d["coefs_"], d["intercepts_"],
                   activation=d.get("params", {}).get("activation", "relu"),
                   out_activation=d.get("out_activation_", "softmax"),
                   classes=None if classes is None else np.asarray(classes))

    @classmethod
    def from_sklearn(cls, clf) -> "MLPModel":
        """A trained sklearn MLPClassifier (reference
        serialize_deserialize_mlp, utils.py:393-460)."""
        return cls(list(clf.coefs_), list(clf.intercepts_),
                   activation=clf.get_params().get("activation", "relu"),
                   out_activation=clf.out_activation_,
                   classes=np.asarray(clf.classes_))

    def to_json(self, path: str) -> None:
        """The reference's JSON schema (the serialize side of
        utils.py:411-437, with the _label_binarizer block its deserializer
        needs), so that the reference and the JAX package load it."""
        classes = self.classes.tolist()
        d = {
            "meta": "mlp",
            "coefs_": [np.asarray(c).tolist() for c in self.coefs],
            "intercepts_": [np.asarray(b).tolist() for b in self.intercepts],
            "loss_": 0.0,
            "n_iter_": 0,
            "n_layers_": len(self.coefs) + 1,
            "n_outputs_": int(self.coefs[-1].shape[1]),
            "out_activation_": self.out_activation,
            "classes_": classes,
            "_label_binarizer": {
                "neg_label": 0, "pos_label": 1, "sparse_output": False,
                "y_type_": "binary" if len(classes) <= 2 else "multiclass",
                "sparse_input_": False,
                "classes_": classes,
            },
            "params": {"activation": self.activation},
        }
        with open(path, "w") as f:
            json.dump(d, f)

    def logits(self, X: np.ndarray) -> np.ndarray:
        """The output layer before its activation, in f64."""
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        act = _ACTIVATIONS[self.activation]
        h = np.asarray(X, dtype=np.float64)
        for W, b in zip(self.coefs[:-1], self.intercepts[:-1]):
            h = act(h @ W + b)
        return h @ self.coefs[-1] + self.intercepts[-1]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        z = self.logits(X)
        if self.out_activation == "softmax":
            z = z - z.max(axis=-1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=-1, keepdims=True)
        if self.out_activation == "logistic":
            return 1.0 / (1.0 + np.exp(-z))
        return z

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.classes[np.argmax(self.predict_proba(X), axis=-1)]


class MLFeatureTools:
    """API mirror of reference MLFeaturetools: the per-k results under
    ``target_dir`` into feature statistics, then a sliding-window vote of
    the MLP for k."""

    def __init__(self, target_dir: str, clf: MLPModel, mis_val: int = 1,
                 hit_val: int = 6, app_data: Optional[Dict] = None,
                 property_list: Sequence[str] = DEFAULT_PROPERTIES):
        self.target_dir = target_dir
        self.clf = clf
        self.mis_val = mis_val
        self.hit_val = hit_val
        self.app_data: Dict = {} if app_data is None else app_data
        self.property_list = list(property_list)

    def build_statistics(self):
        """Each k's statistics (reference buildStatistics :35-69): AIC
        min-max normalized, clusterSilhouetteCoefficients zero-padded to
        the largest k."""
        from ..utils.io import read_cluster_results
        ks = sorted(int(d) for d in os.listdir(self.target_dir)
                    if d.isdigit())
        if not ks:
            raise FileNotFoundError(
                f"no per-k result dirs under {self.target_dir}")
        self.app_data["k"] = np.array(ks)
        n = len(ks)
        stats = ["AIC", "L_errDist", "avgErr", "avgSilhouetteCoefficients"]
        for s in stats:
            self.app_data[s] = np.zeros(n)
        self.app_data["clusterSilhouetteCoefficients"] = np.zeros((n, max(ks)))
        self.app_data["minSilhouetteCoefficients"] = np.zeros(n)
        for i, k in enumerate(ks):
            res = read_cluster_results(os.path.join(self.target_dir, str(k)))
            sils = np.asarray(res["clusterSilhouetteCoefficients"])
            self.app_data["clusterSilhouetteCoefficients"][i, :k] = sils
            self.app_data["minSilhouetteCoefficients"][i] = sils.min()
            for s in stats:
                self.app_data[s][i] = float(np.asarray(res[s]))
        aic = self.app_data["AIC"]
        rng = np.max(aic - np.min(aic))
        self.app_data["AIC"] = (aic - np.min(aic)) / (rng if rng else 1.0)
        return self.app_data

    def predict_statistics(self) -> int:
        """Sliding-window vote (reference predictStatistics :72-100): each
        window predicts an offset 0..6 into itself; a hit adds hit_val
        votes there, a prediction at either end mis_val to every position
        beyond it; the most voted position wins, ties to the largest k."""
        if not self.app_data:
            self.build_statistics()
        ks = self.app_data["k"]
        npreds = ks.shape[0] - ML_WINDOW
        if npreds <= 0:
            raise ValueError(
                f"need more than {ML_WINDOW} k values, have {ks.shape[0]}")
        windows = np.array([
            np.concatenate([self.app_data[p][i:i + ML_WINDOW]
                            for p in self.property_list])
            for i in range(npreds)])
        preds = self.clf.predict(windows).astype(np.int64)
        counts = np.zeros(npreds, dtype=np.int64)
        for i in range(npreds):
            if preds[i] == ML_WINDOW - 1:
                counts[i + ML_WINDOW - 1:] += self.mis_val
            elif preds[i] == 0:
                counts[:i + 1] += self.mis_val
            elif i + preds[i] < npreds:
                counts[i + preds[i]] += self.hit_val
        return int(np.nonzero(counts == counts.max())[0][-1] + ks[0])


def predict_k(results_dir: str, model_json: str, **kw) -> int:
    """The k a model JSON predicts for a sweep's results dir."""
    return MLFeatureTools(results_dir, MLPModel.from_json(model_json),
                          **kw).predict_statistics()


# ---------------------------------------------------------------------------
# Training (beyond the reference, which ships a pretrained sklearn model):
# users retrain the k-predictor on their own labelled sweeps, and the result
# loads in the reference's deserializer (utils.py:438-460) and back.
# ---------------------------------------------------------------------------
def build_training_windows(app_datas: Sequence[Dict],
                           true_ks: Sequence[int],
                           property_list: Sequence[str] = DEFAULT_PROPERTIES):
    """Labelled sweep statistics as (windows, offsets) training pairs.

    ``app_datas`` are build_statistics() dicts, one a sweep, ``true_ks``
    the known k of each. A label is the index offset of the true k inside
    the window, which the vote consumes, clamped to 0 (before the window)
    and ML_WINDOW - 1 (at or past its end)."""
    Xs, ys = [], []
    for app, kt in zip(app_datas, true_ks):
        ks = np.asarray(app["k"])
        npreds = ks.shape[0] - ML_WINDOW
        if npreds <= 0:
            raise ValueError(
                f"sweep over {ks.shape[0]} k values is shorter than the "
                f"{ML_WINDOW + 1} needed for one window")
        kt_idx = int(np.searchsorted(ks, kt))
        for i in range(npreds):
            Xs.append(np.concatenate([np.asarray(app[p])[i:i + ML_WINDOW]
                                      for p in property_list]))
            ys.append(int(np.clip(kt_idx - i, 0, ML_WINDOW - 1)))
    return np.asarray(Xs, np.float64), np.asarray(ys, np.int64)


def _mlp_module(sizes, activation, generator):
    """The torch MLP: Linear layers with glorot-uniform weights drawn from
    ``generator`` and zero biases, the activation between them."""
    import torch
    from torch import nn
    acts = {"relu": nn.ReLU, "tanh": nn.Tanh, "logistic": nn.Sigmoid,
            "identity": nn.Identity}
    if activation not in acts:
        raise ValueError(f"unknown activation {activation!r}")
    layers = []
    for i in range(len(sizes) - 1):
        lin = nn.Linear(sizes[i], sizes[i + 1])
        bound = float(np.sqrt(6.0 / (sizes[i] + sizes[i + 1])))
        with torch.no_grad():
            # (out, in) of nn.Linear: drawn as the (in, out) coefs_ matrix
            lin.weight.copy_((torch.rand((sizes[i], sizes[i + 1]),
                                         generator=generator) * 2 - 1)
                             .mul_(bound).T)
            lin.bias.zero_()
        layers.append(lin)
        if i < len(sizes) - 2:
            layers.append(acts[activation]())
    return nn.Sequential(*layers)


def train_mlp(X, y, hidden: Sequence[int] = (300, 200, 100),
              activation: str = "relu", epochs: int = 300,
              batch_size: int = 32, learning_rate: float = 1e-3,
              alpha: float = 1e-4, seed: int = 0, verbose: bool = False,
              device="cuda", return_module: bool = False):
    """Train a softmax-output MLP classifier and return it as an MLPModel
    (``ml_recognition.py:234-308``): sklearn MLPClassifier's defaults,
    glorot-uniform init, Adam, and the L2 term 0.5 alpha sum(W^2) / batch
    over shuffled minibatches each epoch (the last partial one dropped).
    The init and the shuffles come from a CPU ``torch.Generator`` seeded
    with ``seed``; the training runs in f32 on ``device``, the CUDA card
    unless ``device="cpu"``. ``return_module`` also returns the trained
    ``torch.nn.Sequential``."""
    import torch
    import torch.nn.functional as F
    from ..config import check_device

    device = check_device(torch.device(device))
    X = np.asarray(X, np.float32)
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    n, d = X.shape
    sizes = [d, *hidden, classes.shape[0]]
    g = torch.Generator()
    g.manual_seed(seed)
    net = _mlp_module(sizes, activation, g).to(device)
    weights = [m.weight for m in net if isinstance(m, torch.nn.Linear)]
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    Xt = torch.from_numpy(X).to(device)
    yt = torch.from_numpy(y_idx.astype(np.int64)).to(device)
    bs = min(batch_size, n)
    n_batches = n // bs
    for e in range(epochs):
        perm = torch.randperm(n, generator=g)[:n_batches * bs].to(device)
        total = 0.0
        for b in range(n_batches):
            idx = perm[b * bs:(b + 1) * bs]
            loss = F.cross_entropy(net(Xt[idx]), yt[idx])
            loss = loss + 0.5 * alpha * sum((W * W).sum()
                                            for W in weights) / bs
            opt.zero_grad()
            loss.backward()
            opt.step()
            if verbose:
                total += float(loss)
        if verbose and (e % 50 == 0 or e == epochs - 1):
            print(f"epoch {e}: loss {total / n_batches:.4f}")
    lins = [m for m in net if isinstance(m, torch.nn.Linear)]
    model = MLPModel(
        [m.weight.detach().T.double().cpu().numpy() for m in lins],
        [m.bias.detach().double().cpu().numpy() for m in lins],
        activation=activation, out_activation="softmax", classes=classes)
    return (model, net) if return_module else model


def train_k_predictor(result_dirs: Sequence[str], true_ks: Sequence[int],
                      property_list: Sequence[str] = DEFAULT_PROPERTIES,
                      **train_kw) -> MLPModel:
    """Sweep result dirs with the known k of each -> a trained window
    classifier for MLFeatureTools and predict_k (and, through
    MLPModel.to_json, the reference)."""
    apps = []
    for d in result_dirs:
        tool = MLFeatureTools(d, clf=None, property_list=property_list)
        apps.append(dict(tool.build_statistics()))
    X, y = build_training_windows(apps, true_ks, property_list)
    return train_mlp(X, y, **train_kw)
