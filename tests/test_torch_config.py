"""The port's configuration keys against the JAX package's.

``read_config`` on the repository's example files gives, field for
field, the JAX ``Config`` after ``apply_defaults``; the deprecated keys
map across as the JAX package maps them; the Go-runtime profile knobs
raise when set; the statsd TCP schemes load; and a proxy file that sets
``ssf_destination_address`` and ``trace_api_address`` loads (accepted
and not read, as in the JAX package).
"""

import dataclasses
import pathlib
import sys

import pytest

from veneur_tpu import config as jconfig
from veneur_tpu_torch.config import (Config, UnsupportedConfig,
                                     config_from_dict, read_config,
                                     read_proxy_config)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax(data: dict) -> jconfig.Config:
    cfg = jconfig.Config(**data)
    cfg.apply_defaults()
    cfg.validate()
    return cfg


def _differences(ours, theirs) -> list:
    return [(f.name, getattr(ours, f.name), getattr(theirs, f.name))
            for f in dataclasses.fields(jconfig.Config)
            if getattr(ours, f.name) != getattr(theirs, f.name)]


def test_the_fields_are_the_jax_packages():
    assert ({f.name for f in dataclasses.fields(Config)}
            == {f.name for f in dataclasses.fields(jconfig.Config)})


@pytest.mark.parametrize("name", ["example.yaml", "example_host.yaml"])
def test_example_files_load_equal_to_jax(name):
    path = str(ROOT / name)
    assert _differences(read_config(path), jconfig.read_config(
        path, environ={})) == []


DEPRECATED = [
    {"ssf_buffer_size": 77},
    {"ssf_buffer_size": 77, "datadog_span_buffer_size": 5},
    {"flush_max_per_body": 9},
    {"trace_lightstep_access_token": "t", "trace_lightstep_collector_host":
     "ls:1", "trace_lightstep_maximum_spans": 3,
     "trace_lightstep_num_clients": 2,
     "trace_lightstep_reconnect_period": "5m"},
    {"trace_lightstep_num_clients": 2, "lightstep_num_clients": 4},
    {"num_workers": 0},
    {"num_workers": 3},
]


@pytest.mark.parametrize("data", DEPRECATED)
def test_deprecated_keys_map_as_in_jax(data):
    data = dict(data, hostname="h")
    ours, theirs = config_from_dict(data), _jax(data)
    assert _differences(ours, theirs) == []
    assert ours.datadog_span_buffer_size in (77, 5, 16384)
    assert ours.num_workers >= 1


@pytest.mark.parametrize("key", ["block_profile_rate",
                                 "mutex_profile_fraction"])
def test_go_profile_knobs_raise(key):
    with pytest.raises(ValueError, match=key):
        _jax({key: 1})
    with pytest.raises(ValueError, match=key):
        Config(hostname="h", **{key: 1})
    assert getattr(Config(hostname="h", **{key: 0}), key) == 0


def test_statsd_schemes():
    for spec in ("udp://127.0.0.1:1", "tcp://127.0.0.1:1",
                 "tcp4://127.0.0.1:1", "tcp6://[::1]:1"):
        assert config_from_dict({"statsd_listen_addresses": [spec]}) \
            .statsd_listen_addresses == [spec]
    with pytest.raises(UnsupportedConfig, match="tcp://"):
        Config(statsd_listen_addresses=["unix:///tmp/statsd.sock"])


def test_sink_keys_are_checked(monkeypatch):
    """A malformed duration of a sink raises at load, and the Falconer
    address, a gRPC key, needs grpcio."""
    for key in ("lightstep_reconnect_period", "kafka_metric_buffer_frequency",
                "kafka_span_buffer_frequency"):
        with pytest.raises(ValueError, match="duration"):
            Config(hostname="h", **{key: "soon"})
        assert getattr(Config(hostname="h", **{key: "2s"}), key) == "2s"
    assert Config(hostname="h", falconer_address="f:1").falconer_address \
        == "f:1"
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(UnsupportedConfig, match="grpcio"):
        Config(hostname="h", falconer_address="f:1")


def test_proxy_file_with_the_unread_keys_loads(tmp_path):
    path = tmp_path / "proxy.yaml"
    path.write_text((ROOT / "example_proxy.yaml").read_text()
                    + "\nssf_destination_address: \"udp://127.0.0.1:8128\"\n"
                    "trace_api_address: \"http://127.0.0.1:8126\"\n")
    ours = read_proxy_config(str(path))
    theirs = jconfig.read_proxy_config(str(path), environ={})
    for key in ("ssf_destination_address", "trace_api_address",
                "forward_address", "http_address", "forward_timeout"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert ours.trace_api_address == "http://127.0.0.1:8126"
