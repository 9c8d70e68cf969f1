"""TF object checkpoint -> the port's state_dict.

The port's counterpart of ``mmt_tpu/train/tf_checkpoint.py``, read without
TensorFlow (``train/tf_bundle.py``).  Lets users of the reference bring
their trained checkpoints (``tf.train.Checkpoint(model=MmtPretrainingModel)``
object graphs; reference ``src/prediction_helper.py:190-195``) into the
port.

The converter works in the Flax namespace, as the JAX package's does: the
model's tensors become the Flax tree (``convert.flax_from_state_dict``),
the rules, passes, warnings and errors below are the JAX package's to the
letter, and the result comes back through ``convert.params_from_flax``,
which checks every name and shape.  Strategy: read all variables, normalize
the object paths, apply the rename rules for the encoder / heads, then
resolve anything left by unique (path-suffix, shape) match.  Strict by
default: unmatched target parameters raise with a readable report.

Transpositions: TF Dense kernels are [in, out] like Flax; the q/k/v
kernels are [hidden, heads, head_dim] in the Flax tree against TF's
[hidden, hidden] -- reshaped here.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from mmt_tpu_torch.convert import (
    _flatten,
    _unflatten,
    flax_from_state_dict,
    flax_paths,
    params_from_flax,
)
from mmt_tpu_torch.train.tf_bundle import BundleReader

logger = logging.getLogger("mmt_tpu_torch")

# (regex on normalized TF path) -> our flat path template.
DEFAULT_RULES: List[Tuple[str, str]] = [
    # --- encoder embeddings ---
    (r"encoder/_?word_embedding_layer/embedding_table",
     "encoder/word_embeddings/embedding_table"),
    (r"encoder/_?word_embedding_layer/embedding_projection/kernel",
     "encoder/word_embeddings/embedding_projection/kernel"),
    (r"encoder/_?word_embedding_layer/embedding_projection/bias",
     "encoder/word_embeddings/embedding_projection/bias"),
    (r"encoder/_?segment_embedding_layer/embedding_table",
     "encoder/segment_embeddings/embedding_table"),
    (r"encoder/_?position_embedding_layer/embeddings",
     "encoder/absolute_position_embeddings"),
    (r"encoder/_?patch_embedding_projection/kernel",
     "encoder/patch_embedding_projection/kernel"),
    (r"encoder/_?patch_embedding_projection/bias",
     "encoder/patch_embedding_projection/bias"),
    (r"encoder/_?embedding_norm_layer/gamma",
     "encoder/embeddings_layer_norm/scale"),
    (r"encoder/_?embedding_norm_layer/beta",
     "encoder/embeddings_layer_norm/bias"),
    (r"encoder/_?pooler_layer/kernel", "encoder/pooler_transform/kernel"),
    (r"encoder/_?pooler_layer/bias", "encoder/pooler_transform/bias"),
]

# Pinned rules for the etcmodel ``RelativeTransformerLayers`` internals
# (reference compute core, ``src/modeling/models/mmt_encoder.py:124-135``).
# The layer keeps per-layer sublayer *lists*, which TF object checkpoints
# serialize as numeric children; projection sublayers follow the
# ``{query,key,value,output}_projection`` naming and the relative bias
# table is ``relative_emb_table`` (etcmodel layers/attention.py API
# surface, SURVEY.md section 2.3).  Exact upstream attribute names cannot
# be re-verified in this offline environment; checkpoints whose layout
# differs fall through to the unique-(suffix, shape) pass and its
# readable unmatched report -- extend ``extra_rules`` from there.
# Templates may use regex group references (\1 = layer index).
ETCMODEL_RULES: List[Tuple[str, str]] = [
    (r"encoder/(?:_?transformer_layers/)?attention_layers/(\d+)"
     r"/(?:[a-z_]+/)?query_projection/(kernel|bias)",
     r"encoder/transformer/layer_\1/attention/query/\2"),
    (r"encoder/(?:_?transformer_layers/)?attention_layers/(\d+)"
     r"/(?:[a-z_]+/)?key_projection/(kernel|bias)",
     r"encoder/transformer/layer_\1/attention/key/\2"),
    (r"encoder/(?:_?transformer_layers/)?attention_layers/(\d+)"
     r"/(?:[a-z_]+/)?value_projection/(kernel|bias)",
     r"encoder/transformer/layer_\1/attention/value/\2"),
    (r"encoder/(?:_?transformer_layers/)?attention_layers/(\d+)"
     r"/(?:[a-z_]+/)?output_projection/(kernel|bias)",
     r"encoder/transformer/layer_\1/attention/output/\2"),
    (r"encoder/(?:_?transformer_layers/)?attention_layers/(\d+)"
     r"/(?:[a-z_]+/)?relative_emb_table",
     r"encoder/transformer/layer_\1/attention/relative_emb_table"),
    (r"encoder/(?:_?transformer_layers/)?attention_norm_layers/(\d+)/gamma",
     r"encoder/transformer/layer_\1/attention_layer_norm/scale"),
    (r"encoder/(?:_?transformer_layers/)?attention_norm_layers/(\d+)/beta",
     r"encoder/transformer/layer_\1/attention_layer_norm/bias"),
    (r"encoder/(?:_?transformer_layers/)?feed_forward_norm_layers/(\d+)/gamma",
     r"encoder/transformer/layer_\1/ffn_layer_norm/scale"),
    (r"encoder/(?:_?transformer_layers/)?feed_forward_norm_layers/(\d+)/beta",
     r"encoder/transformer/layer_\1/ffn_layer_norm/bias"),
    (r"encoder/(?:_?transformer_layers/)?feed_forward_layers/(\d+)"
     r"/(?:[a-z_]+/)?intermediate(?:_dense)?/(kernel|bias)",
     r"encoder/transformer/layer_\1/intermediate/\2"),
    (r"encoder/(?:_?transformer_layers/)?feed_forward_layers/(\d+)"
     r"/(?:[a-z_]+/)?output(?:_dense)?/(kernel|bias)",
     r"encoder/transformer/layer_\1/ffn_output/\2"),
]


# Inverse of the pinned rules: our canonical flat path -> the reference
# TF object path (one canonical spelling per rule).  Used by
# ``export_tf_layout`` so a JAX->TF-layout->JAX round trip can pin the
# converter's full-tree coverage (tests/test_tf_checkpoint.py), and so
# users can emit reference-shaped variable dicts for external
# comparison against etcmodel checkpoints.
EXPORT_RULES: List[Tuple[str, str]] = [
    (r"encoder/word_embeddings/embedding_table",
     "encoder/_word_embedding_layer/embedding_table"),
    (r"encoder/word_embeddings/embedding_projection/(kernel|bias)",
     r"encoder/_word_embedding_layer/embedding_projection/\1"),
    (r"encoder/segment_embeddings/embedding_table",
     "encoder/_segment_embedding_layer/embedding_table"),
    (r"encoder/absolute_position_embeddings",
     "encoder/_position_embedding_layer/embeddings"),
    (r"encoder/patch_embedding_projection/(kernel|bias)",
     r"encoder/_patch_embedding_projection/\1"),
    (r"encoder/embeddings_layer_norm/scale",
     "encoder/_embedding_norm_layer/gamma"),
    (r"encoder/embeddings_layer_norm/bias",
     "encoder/_embedding_norm_layer/beta"),
    (r"encoder/pooler_transform/(kernel|bias)",
     r"encoder/_pooler_layer/\1"),
    (r"encoder/transformer/layer_(\d+)/attention/(query|key|value|output)"
     r"/(kernel|bias)",
     r"encoder/_transformer_layers/attention_layers/\1/\2_projection/\3"),
    (r"encoder/transformer/layer_(\d+)/attention/relative_emb_table",
     r"encoder/_transformer_layers/attention_layers/\1/relative_emb_table"),
    (r"encoder/transformer/layer_(\d+)/attention_layer_norm/scale",
     r"encoder/_transformer_layers/attention_norm_layers/\1/gamma"),
    (r"encoder/transformer/layer_(\d+)/attention_layer_norm/bias",
     r"encoder/_transformer_layers/attention_norm_layers/\1/beta"),
    (r"encoder/transformer/layer_(\d+)/ffn_layer_norm/scale",
     r"encoder/_transformer_layers/feed_forward_norm_layers/\1/gamma"),
    (r"encoder/transformer/layer_(\d+)/ffn_layer_norm/bias",
     r"encoder/_transformer_layers/feed_forward_norm_layers/\1/beta"),
    (r"encoder/transformer/layer_(\d+)/intermediate/(kernel|bias)",
     r"encoder/_transformer_layers/feed_forward_layers/\1/intermediate/\2"),
    (r"encoder/transformer/layer_(\d+)/ffn_output/(kernel|bias)",
     r"encoder/_transformer_layers/feed_forward_layers/\1/output/\2"),
]


def flax_target(model: nn.Module, state: Optional[Dict[str, torch.Tensor]] = None):
    """The flat Flax tree ({path tuple: array}) of ``state`` (default the
    model's own), in the sorted order of a JAX pytree's keys, which the
    JAX package's reports list."""
    tree = flax_from_state_dict(model.state_dict() if state is None else state, model)
    return dict(sorted(_flatten(tree).items()))


def export_tf_layout(state: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's ``state`` -> {reference TF object path: array}.

    Kernels that the Flax tree keeps factored by head ([hidden, heads,
    head_dim] etc.) are flattened to the reference's 2-D layouts,
    mirroring what ``convert_tf_checkpoint`` reshapes back.  Paths without
    a pinned rule keep their canonical spelling (the converter's unique
    suffix+shape pass recovers them).
    """
    out: Dict[str, np.ndarray] = {}
    for tpath, val in flax_target(model, state).items():
        s = "/".join(tpath)
        name = s
        for pat, tmpl in EXPORT_RULES:
            m = re.fullmatch(pat, s)
            if m:
                name = m.expand(tmpl)
                break
        arr = np.asarray(val)
        if re.search(r"(query|key|value)_projection/kernel$", name):
            arr = arr.reshape(arr.shape[0], -1)  # [H, heads, dh] -> [H, H]
        elif re.search(r"(query|key|value)_projection/bias$", name):
            arr = arr.reshape(-1)
        elif name.endswith("output_projection/kernel") and arr.ndim == 3:
            arr = arr.reshape(-1, arr.shape[-1])  # [heads, dh, H] -> [H, H]
        elif name.endswith("relative_emb_table") and arr.ndim == 3:
            arr = arr.reshape(arr.shape[0], -1)  # [V, heads, dh] -> [V, H]
        out[name] = arr
    return out


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Reads every variable from a TF checkpoint into {normalized_path: array}."""
    reader = BundleReader(path)
    out = {}
    for key in reader.shapes():
        if "optimizer" in key or key.startswith("_"):
            continue
        norm = key.replace("/.ATTRIBUTES/VARIABLE_VALUE", "")
        norm = re.sub(r"^model/", "", norm)
        out[norm] = reader.get_tensor(key)
    return out


def _convert(
    tf_vars: Dict[str, np.ndarray],
    flat_target: Dict[Tuple[str, ...], np.ndarray],
    rules: List[Tuple[str, str]],
    strict: bool,
):
    """(merged flat tree, the assigned paths): the JAX package's two passes."""
    assigned: Dict[Tuple[str, ...], np.ndarray] = {}
    used_src = set()

    def try_assign(tpath: Tuple[str, ...], value: np.ndarray, src: str) -> bool:
        if tpath not in flat_target or tpath in assigned:
            return False
        want = flat_target[tpath]
        if value.shape != want.shape:
            if value.size == want.size:
                value = value.reshape(want.shape)
            else:
                return False
        assigned[tpath] = np.asarray(value, dtype=np.asarray(want).dtype)
        used_src.add(src)
        return True

    # Pass 1: explicit rules (templates may use regex group references).
    for src, value in tf_vars.items():
        for pattern, template in rules:
            m = re.fullmatch(pattern, src)
            if m:
                try_assign(tuple(m.expand(template).split("/")), value, src)
                break

    # Pass 2: unique (suffix, shape) matching for the rest.
    remaining_src = {k: v for k, v in tf_vars.items() if k not in used_src}
    remaining_tgt = [p for p in flat_target if p not in assigned]

    def suffix_tokens(path_str: str):
        toks = [t.lstrip("_") for t in path_str.split("/")]
        return toks

    for src, value in sorted(remaining_src.items()):
        stoks = suffix_tokens(src)
        candidates = []
        for tpath in remaining_tgt:
            if tpath in assigned:
                continue
            want = flat_target[tpath]
            if np.asarray(want).size != np.asarray(value).size:
                continue
            # score: count of shared trailing tokens (gamma/beta aliased).
            alias = {"gamma": "scale", "beta": "bias", "kernel": "kernel"}
            score = 0
            for a, b in zip(reversed(stoks), reversed(tpath)):
                if a == b or alias.get(a) == b:
                    score += 1
                else:
                    break
            if score:
                candidates.append((score, tpath))
        if candidates:
            candidates.sort(reverse=True)
            if len(candidates) == 1 or candidates[0][0] > candidates[1][0]:
                if try_assign(candidates[0][1], value, src):
                    logger.warning(
                        "tf_checkpoint: no pinned rule for %r; assigned to "
                        "%s by unique suffix+shape match -- verify, and pin "
                        "with extra_rules if correct", src,
                        "/".join(candidates[0][1]),
                    )

    missing = [p for p in flat_target if p not in assigned]
    if missing:
        msg = (
            f"{len(missing)}/{len(flat_target)} target params unmatched, e.g. "
            + ", ".join("/".join(p) for p in missing[:8])
        )
        if strict:
            raise ValueError(
                msg + "\nPass extra_rules=[(tf_path_regex, our_path), ...] or "
                "strict=False to keep fresh inits for unmatched params."
            )
        logger.warning(msg)

    merged = dict(flat_target)
    merged.update(assigned)
    return merged, set(assigned)


def convert_tf_checkpoint(
    tf_vars: Dict[str, np.ndarray],
    model: nn.Module,
    extra_rules: Optional[List[Tuple[str, str]]] = None,
    strict: bool = True,
    assigned: Optional[Set[str]] = None,
) -> Dict[str, torch.Tensor]:
    """Returns ``model``'s state_dict (float32, on the CPU) with every
    matchable tensor replaced; ``assigned``, if given, receives the port
    names of the tensors the checkpoint filled.

    Matching passes: (1) rename rules, (2) unique suffix+shape match
    (covers transformer-layer internals whose upstream attribute names
    vary). Shapes are adapted for the q/k/v [H, H] -> [H, heads, dh]
    reshape.
    """
    rules = DEFAULT_RULES + ETCMODEL_RULES + (extra_rules or [])
    merged, done = _convert(tf_vars, flax_target(model), rules, strict)
    if assigned is not None:
        names = {tuple(path.split("/")): name for name, path in flax_paths(model).items()}
        assigned.update(names[p] for p in done)
    return params_from_flax(_unflatten(merged), model)
