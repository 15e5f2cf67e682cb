"""The port's topological module against the reference's: the host
partitioner is the same numpy code (identical labels), and the three device
functions give the same (integer / boolean) answers on random maps: with
dead edges, with the `[0, 0]` entry that only dead edges point at, and with
area ids at and beyond the 64-area cap.  The float scores are held to 1e-6
relative (one sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd360_tpu.slam import topological as JT
from rgbd360_tpu_torch.slam import topological as TT


def random_sso(n, rng, blocks=3):
    """A block-structured co-visibility matrix: strong inside a block,
    weak across."""
    label = np.sort(rng.integers(0, blocks, n))
    sso = np.where(label[:, None] == label[None, :], rng.uniform(0.5, 1, (n, n)),
                   rng.uniform(0, 0.05, (n, n)))
    sso = np.triu(sso, 1)
    return (sso + sso.T).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_host_partition_identical(seed):
    rng = np.random.default_rng(seed)
    sso = random_sso(14, rng)
    w = sso.astype(np.float64)
    np.testing.assert_array_equal(
        TT.recursive_spectral_partition(w, 0.8, 3), JT.recursive_spectral_partition(w, 0.8, 3))
    part = rng.uniform(size=14) < 0.5
    assert TT.normalized_cut_value(w, part) == JT.normalized_cut_value(w, part)
    np.testing.assert_array_equal(TT._fiedler_bisect(w), JT._fiedler_bisect(w))


class _Map:
    """The fields the host functions read, on either package's arrays."""

    def __init__(self, xp, n_kf, sso, area, n_areas, edges_ij, emask):
        class G:
            pass

        self.graph = G()
        self.graph.edges_ij, self.graph.emask = xp(edges_ij), xp(emask)
        self.n_kf, self.sso, self.area = xp(np.int32(n_kf)), xp(sso), xp(area)
        self.n_areas = xp(np.int32(n_areas))


def random_map(seed, n=16, e=24, n_kf=11, n_areas=4, area_max=None):
    rng = np.random.default_rng(seed)
    sso = np.zeros((n, n), np.float32)
    sso[:n_kf, :n_kf] = random_sso(n_kf, rng)
    sso = np.triu(sso)  # the map stores one triangle for some pairs
    area = np.zeros(n, np.int32)
    area[:n_kf] = rng.integers(0, area_max or n_areas, n_kf)
    edges = np.full((e, 2), -1, np.int32)
    live = e - 6
    edges[:live] = rng.integers(1, n_kf, (live, 2))  # no live edge touches keyframe 0
    emask = np.arange(e) < live
    emask[rng.integers(0, live, 3)] = False  # dead edges inside the live range
    area[0] = 0
    return dict(n_kf=n_kf, sso=sso, area=area, n_areas=n_areas, edges_ij=edges, emask=emask)


@pytest.mark.parametrize("seed", range(3))
def test_partition_map_and_host_helpers(seed):
    m = random_map(seed)
    jm, tm = _Map(jnp.asarray, **m), _Map(torch.as_tensor, **m)
    ja, jn = JT.partition_map(jm, 0.8)
    ta, tn = TT.partition_map(tm, 0.8)
    np.testing.assert_array_equal(ta, ja)
    assert tn == jn
    ta2, _ = TT.partition_map(tm, 0.8, sso=torch.from_numpy(m["sso"]), n_kf=m["n_kf"])
    np.testing.assert_array_equal(ta2, ja)
    np.testing.assert_array_equal(TT.representative_keyframes(tm), JT.representative_keyframes(jm))
    np.testing.assert_array_equal(TT.neighbor_areas(tm), JT.neighbor_areas(jm))


@pytest.mark.parametrize("area_max", [None, 70], ids=["few_areas", "ids_beyond_the_cap"])
@pytest.mark.parametrize("seed", range(3))
def test_device_functions(seed, area_max):
    n = 80 if area_max else 16  # capacity above the 64-area cap
    m = random_map(seed, n=n, n_kf=n - 5, area_max=area_max)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in m.items()}
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in m.items()}
    js, _ = JT._rep_scores(j["sso"], j["area"], j["n_kf"])
    ts, _ = TT._rep_scores(t["sso"], t["area"], t["n_kf"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    jn = np.asarray(JT.area_adjacency_device(j["area"], j["edges_ij"], j["emask"], n))
    tn = TT.area_adjacency_device(t["area"], t["edges_ij"], t["emask"], n).numpy()
    np.testing.assert_array_equal(tn, jn)
    assert tn.shape == (min(n, 64),) * 2 and tn[0, 0]
    jr = np.asarray(JT.representative_mask_device(j["sso"], j["area"], j["n_kf"]))
    tr = TT.representative_mask_device(t["sso"], t["area"], torch.tensor(m["n_kf"])).numpy()
    np.testing.assert_array_equal(tr, jr)
    if not area_max:
        reps = TT.representative_keyframes(_Map(torch.as_tensor, **m))
        np.testing.assert_array_equal(np.flatnonzero(tr), np.sort(reps[reps >= 0]))


def test_dead_edges_do_not_clear_the_diagonal():
    """Every dead edge lands on area pair (0, 0) with the value False: a
    max-reduction leaves the diagonal entry True, an indexed store would
    clear it; and area 0 gains no neighbour from them."""
    area = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    edges = torch.tensor([[1, 2], [-1, -1], [2, 3], [-1, -1]], dtype=torch.int32)
    emask = torch.tensor([True, False, False, False])
    neigh = TT.area_adjacency_device(area, edges, emask, 4)
    expect = np.eye(4, dtype=bool)
    expect[1, 2] = expect[2, 1] = True
    np.testing.assert_array_equal(neigh.numpy(), expect)
    ref = JT.area_adjacency_device(jnp.asarray(area.numpy()), jnp.asarray(edges.numpy()),
                                   jnp.asarray(emask.numpy()), 4)
    np.testing.assert_array_equal(neigh.numpy(), np.asarray(ref))
    # no live member in an area: no representative, and slot 0 stays clear
    rep = TT.representative_mask_device(torch.zeros(4, 4), area, torch.tensor(0))
    assert not rep.any()
