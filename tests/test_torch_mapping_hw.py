"""Port parity: the port's copies of ``core/mapping.py`` and
``core/hw_model.py`` against the reference, for every Table I network.

These are pure-Python copies, so everything must be exactly equal — the
mapping, every analytic cost, and the paper's golden values (Table III
core counts, Table IV's 0.77 us beat) as ``tests/test_golden_paper.py``
pins them for the reference.
"""
import dataclasses
import re

import pytest

pytest.importorskip("torch")

from repro.configs import paper_apps as japps  # noqa: E402
from repro.core import hw_model as jhw, mapping as jmap  # noqa: E402
from repro_torch.configs import paper_apps as tapps  # noqa: E402
from repro_torch.core import hw_model as thw, mapping as tmap  # noqa: E402

APPS = sorted(japps.NETWORKS)


def _plain(obj):
    """A dataclass tree as plain dicts/tuples, so objects of the two
    packages' (distinct) classes compare by value."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(o) for o in obj)
    return obj


def test_configs_match():
    assert tapps.NETWORKS == japps.NETWORKS
    assert _plain(tapps.PAPER_SPEC) == _plain(japps.PAPER_SPEC)
    assert _plain(tapps.FLOAT_SPEC) == _plain(japps.FLOAT_SPEC)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("share", [False, True])
def test_map_network_equal(app, share):
    dims = japps.NETWORKS[app]
    ref = jmap.map_network(dims, share_small_layers=share)
    got = tmap.map_network(dims, share_small_layers=share)
    assert _plain(got) == _plain(ref)
    assert got.cores == ref.cores
    assert [l.total_cores for l in got.layers] == \
        [l.total_cores for l in ref.layers]
    assert _plain(tmap.map_autoencoder_pretraining(
        dims, share_small_layers=share)) == _plain(
        jmap.map_autoencoder_pretraining(dims, share_small_layers=share))


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("share", [False, True])
def test_network_cost_equal(app, share):
    dims = japps.NETWORKS[app]
    for pretraining in (False, True):
        assert _plain(thw.network_cost(
            app, dims, pretraining=pretraining,
            share_small_layers=share)) == _plain(jhw.network_cost(
                app, dims, pretraining=pretraining,
                share_small_layers=share))


@pytest.mark.parametrize("app", APPS)
def test_split_farm_pipeline_costs_equal(app):
    dims = japps.NETWORKS[app]
    for kw in ({"max_cores_per_chip": 144}, {"max_cores_per_chip": 8},
               {"n_chips": 2}):
        try:
            ref = _plain(jmap.split_network(jmap.map_network(dims), **kw))
        except ValueError as e:          # a layer that fits no chip
            with pytest.raises(ValueError, match=re.escape(str(e))):
                tmap.split_network(tmap.map_network(dims), **kw)
            continue
        assert _plain(tmap.split_network(tmap.map_network(dims),
                                         **kw)) == ref
    for n in (1, 2, 4):
        assert _plain(thw.farm_cost(app, dims, n)) == \
            _plain(jhw.farm_cost(app, dims, n))
    assert _plain(thw.pipeline_cost(app, dims, n_chips=2, batch=4,
                                    n_micro=2)) == \
        _plain(jhw.pipeline_cost(app, dims, n_chips=2, batch=4, n_micro=2))
    assert _plain(thw.gpu_cost(dims, train=True)) == \
        _plain(jhw.gpu_cost(dims, train=True))


def test_schedule_1f1b_equal():
    args = ([1.0, 2.0, 1.5], [2.0, 3.0, 2.5], [0.1, 0.2, 0.0],
            [0.2, 0.1, 0.0])
    for n_micro in (1, 2, 5):
        assert thw.schedule_1f1b(*args, n_micro) == \
            jhw.schedule_1f1b(*args, n_micro)


def test_golden_table_iii_and_iv():
    golden = {"mnist_class": 13, "mnist_ae": 13, "isolet_class": 160,
              "isolet_ae": 160, "kdd_anomaly": 2}
    for app, cores in golden.items():
        assert tmap.map_network(thw.PAPER_NETWORKS[app]).cores == cores
    assert tmap.map_network([41, 15, 41], share_small_layers=True).cores == 1
    assert thw.pipeline_beat_us() == pytest.approx(0.77, abs=1e-9)
    assert thw.PAPER_TABLE_IV == jhw.PAPER_TABLE_IV
    assert thw.PAPER_TABLE_III == jhw.PAPER_TABLE_III
    c = thw.network_cost("mnist_class", thw.PAPER_NETWORKS["mnist_class"])
    assert c.cores == 13
    assert c.train.time_us == pytest.approx(12.83, abs=1e-9)
    assert c.infer.time_us == pytest.approx(5.63, abs=1e-9)
