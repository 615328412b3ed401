"""The generic lanes of parallel/mesh.py (KP2, KE5) with real arithmetic
on a mesh of 3 CPU shards (REAL_K): against the unsharded port
wrapper and the reference's unsharded JAX function (fabric_tpu.ops.p256
.verify_words, ed25519.verify_words), bit for bit, with the same count.
Apart from tests/test_torch_mesh.py only because each plain call takes
seconds: two files run side by side under xdist."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import jax.numpy as jnp

from fabric_tpu.ops import ed25519 as ref_ed
from fabric_tpu.ops import p256 as ref_p256
from fabric_tpu_torch.ops import ed25519, ed25519_tables, p256, p256_tables
from fabric_tpu_torch.parallel import mesh as M

from test_torch_mesh import CPU, check_lane, ed_items, p256_items, \
    sharded_run


@pytest.fixture(scope="module")
def lane_p256():
    """KP2: a good signature and one with a wrong digest."""
    rows = p256_items(2, 1, bad={1}, seed=3)
    words = [p256.ints_to_words([r[c] for r in rows]) for c in range(5)]
    table = p256_tables.g_table(CPU)
    return {"labels": [True, False],
            "jax": np.asarray(ref_p256.verify_words(*words)).tolist(),
            "port": p256.p256_verify(*[torch.from_numpy(w) for w in words],
                                     table).tolist(),
            "sharded": sharded_run(M.sharded_p256_verify, [*words, table])}


@pytest.fixture(scope="module")
def lane_ed25519():
    """KE5: a good signature and one over another message."""
    rows = ed_items(2, 1, bad={1}, seed=5)
    packed = ed25519.pack_verify_inputs(*map(list, zip(*rows)))
    table = ed25519_tables.b_table(CPU)
    return {"labels": [True, False],
            "jax": np.asarray(ref_ed.verify_words(
                *[jnp.asarray(a) for a in packed])).tolist(),
            "port": ed25519.ed25519_verify(
                *[torch.from_numpy(np.ascontiguousarray(a)) for a in packed],
                table).tolist(),
            "sharded": sharded_run(M.sharded_ed25519_verify,
                                    [*packed, table])}


@pytest.mark.parametrize("lane", ["lane_p256", "lane_ed25519"])
def test_sharded_lane_matches_unsharded_and_reference(lane, request):
    check_lane(request.getfixturevalue(lane))
