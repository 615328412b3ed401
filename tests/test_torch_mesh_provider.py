"""CudaProvider(mesh=...) with real arithmetic on CPU shards against
SoftwareProvider and the single-device port provider, on the corpora of
tests/test_torch_bccsp.py (the port's cases of
tests/test_sharded_verify.py:138-182), with fallbacks == 0; and the
idemix lane of parallel/mesh.py (KB8) on 3 CPU shards (REAL_K), on
idemix_pair_probe's green and red checks.  Apart from
tests/test_torch_mesh.py only because each plain call takes seconds."""
import numpy as np
import pytest
import torch

from fabric_tpu_torch.bccsp.cuda import CudaProvider
from fabric_tpu_torch.bccsp.sw import SoftwareProvider
from fabric_tpu_torch.ops import bn254
from fabric_tpu_torch.parallel import mesh as M

from test_torch_bccsp import corpora, port  # noqa: F401
from test_torch_mesh import check_lane, cpu_mesh, sharded_run


@pytest.fixture(scope="module")
def lane_idemix():
    """KB8: idemix_pair_probe's green check, e(G1, g2) e(-G1, g2) == 1,
    and its red one, e(G1, g2)^2 == 1, as one batch of two."""
    _, green, red = CudaProvider(device="cpu").idemix_pair_probe(1)
    args = list(green[:3]) + [torch.cat([g, r], 1) for g, r in
                              zip(green[3:], red[3:])]
    args[2] = torch.zeros(2, dtype=torch.int32)
    return {"labels": [True, False], "jax": [True, False],
            "port": bn254.bn254_pairing_check(*args).tolist(),
            "sharded": sharded_run(M.sharded_idemix_pair_verify, args)}


def test_sharded_idemix_lane_matches_unsharded_and_labels(lane_idemix):
    check_lane(lane_idemix)


@pytest.fixture(scope="module")
def provider_runs(corpora):
    """The low-S corpora of tests/test_torch_bccsp.py as one batch through
    SW, the single-device port provider and the provider on 2 CPU shards."""
    batch = []
    for name in ("mixed", "malformed", "high_s", "adversarial", "swapped"):
        batch += corpora[name][0]
    items = port(batch)
    single = CudaProvider(device="cpu")
    sharded = CudaProvider(mesh=cpu_mesh(2))
    return {"sw": SoftwareProvider().batch_verify(items),
            "single": single.batch_verify(items),
            "sharded": sharded.batch_verify(items),
            "single_prov": single, "sharded_prov": sharded, "n": len(items)}


def test_provider_on_mesh_matches_sw_and_single_device(provider_runs):
    got = provider_runs["sharded"]
    np.testing.assert_array_equal(got, provider_runs["single"])
    np.testing.assert_array_equal(got, provider_runs["sw"])
    assert 0 < got.sum() < provider_runs["n"]
    one, many = provider_runs["single_prov"], provider_runs["sharded_prov"]
    assert many.stats == one.stats            # dispatches count sharded calls
    assert many.stats["fallbacks"] == 0


