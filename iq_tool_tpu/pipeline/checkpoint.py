"""Checkpoint / resume of streaming state.

The reference has none (SURVEY.md section 5): streams are one-shot and a
crash loses the capture position.  Here the full carry pytree (filter
tails, NCO phase, resampler history, AGC/IQ state) plus the input frame
offset is periodically persisted, so a processing job can resume exactly
where it stopped — the output continues sample-exact because ALL stream
memory lives in the carry.

Complex leaves are split to stacked float32 planes by a jitted function
before device_get, and rejoined by a jitted function after device_put on
restore, so the file holds real arrays only.
"""

from __future__ import annotations

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np


def _split_complex(tree):
    def f(v):
        if jnp.iscomplexobj(v):
            return jnp.stack([jnp.real(v), jnp.imag(v)])
        return v
    return jax.tree_util.tree_map(f, tree)


def _join_complex(tree, complex_mask):
    def f(v, was_complex):
        if was_complex:
            return (v[0] + 1j * v[1]).astype(jnp.complex64)
        return v
    return jax.tree_util.tree_map(f, tree, complex_mask)


def save_checkpoint(path: str, carry, frames_in: int, frames_out: int,
                    meta: dict | None = None) -> None:
    """Atomically write carry + stream position to ``path`` (.npz)."""
    split = jax.jit(_split_complex)(carry)
    host = jax.tree_util.tree_map(lambda v: np.asarray(jax.device_get(v)), split)
    leaves, treedef = jax.tree_util.tree_flatten(host)
    cmask = [bool(jnp.iscomplexobj(v))
             for v in jax.tree_util.tree_leaves(carry)]
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps({
        "frames_in": frames_in,
        "frames_out": frames_out,
        "complex_mask": cmask,
        "treedef": str(treedef),
        "extra": meta or {},
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            # fsync before the rename: a journaled rename of an
            # unsynced temp file can destroy BOTH checkpoints on power
            # loss — the exact crash class checkpoints must survive
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, example_carry):
    """Returns (carry, frames_in, frames_out, extra_meta).

    ``example_carry`` provides the pytree structure (from chain.init_carry);
    shapes/dtypes are validated against it.
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    _, treedef = jax.tree_util.tree_flatten(example_carry)
    host_tree = jax.tree_util.tree_unflatten(treedef, leaves)
    cmask_tree = jax.tree_util.tree_unflatten(treedef, meta["complex_mask"])

    restored = jax.jit(lambda t: _join_complex(t, cmask_tree))(host_tree)

    # validate against the example
    def check(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"checkpoint leaf mismatch: {a.shape}/{a.dtype} vs "
                f"{b.shape}/{b.dtype} — chain config differs from the "
                "checkpointed one")
        return a
    jax.tree_util.tree_map(check, restored, example_carry)
    return restored, meta["frames_in"], meta["frames_out"], meta["extra"]
