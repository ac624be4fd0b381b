"""Service discovery for the proxy ring (SURVEY §2.2 L9).

Port of ``veneur_tpu/discovery/__init__.py``:
``Discoverer.get_destinations_for_service(name)`` returns the currently
healthy global-veneur destinations (``discoverer.go:5-7``), with a
static list, a peers file, Consul (``consul.go:16-55``) and Kubernetes
(``kubernetes.go:14-91``) on stdlib ``urllib``; :class:`RingWatcher`
turns refreshes into membership diffs. The leadership lease of the
global HA pair lives in ``discovery/lease.py`` (re-exported here):
the ``file://`` and ``consul://`` lease backends, the
:class:`LeaseElector` state machine, and :class:`LeaderDiscoverer`, the
lease holder as a one-member ``Discoverer``.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import urllib.parse
import urllib.request
from typing import List, Optional, Protocol, Sequence

from veneur_tpu_torch.discovery.lease import (ConsulLease,  # noqa: F401
                                              FileLease, LeaderDiscoverer,
                                              LeaseElector, LeaseState,
                                              lease_backend_from_url)
from veneur_tpu_torch.resilience import (Deadline, RetryPolicy,
                                         call_with_retry)

log = logging.getLogger("veneur.discovery")


class Discoverer(Protocol):
    def get_destinations_for_service(self, service_name: str) -> List[str]:
        ...


class StaticDiscoverer:
    """A fixed destination list (the no-Consul configuration, where
    forward_address is the single destination — proxy.go:121-133)."""

    def __init__(self, destinations: Sequence[str]):
        self._destinations = list(destinations)

    def get_destinations_for_service(self, service_name: str) -> List[str]:
        return list(self._destinations)


class FilePeersDiscoverer:
    """Membership from a local file, one address per line (``#`` starts
    a comment). The configmap/ansible-managed flavor of discovery: an
    operator (or an orchestrator sidecar) rewrites the file and the
    next refresh sees the new fleet — no Consul required. Also the
    lever the elastic-resharding chaos tests pull across a process
    boundary. A missing/unreadable file raises, which the refresh
    paths translate into keep-last-good."""

    def __init__(self, path: str):
        self.path = path

    def get_destinations_for_service(self, service_name: str) -> List[str]:
        with open(self.path) as f:
            lines = f.read().splitlines()
        return [ln.strip() for ln in lines
                if ln.strip() and not ln.lstrip().startswith("#")]


class MembershipChange:
    """One observed fleet-membership transition (old → new)."""

    def __init__(self, old: Sequence[str], new: Sequence[str]):
        self.old = list(old)
        self.new = list(new)

    @property
    def added(self) -> List[str]:
        return sorted(set(self.new) - set(self.old))

    @property
    def removed(self) -> List[str]:
        return sorted(set(self.old) - set(self.new))

    def __repr__(self):
        return (f"MembershipChange(+{self.added} -{self.removed} "
                f"-> {len(self.new)} members)")


class RingWatcher:
    """Discovery refresh → membership diff, with the same
    keep-last-good semantics the proxy's ``_refresh_ring`` applies
    (proxy.go:337-371; the proxy keeps its own copy because its
    refresh also budgets retries and prunes breakers per ring). Ring
    consumers one tier down (the JAX package's elastic-resharding
    handoff manager) drive this one:

    * a refresh failure or an EMPTY result keeps the previous
      membership (and returns None — no transition happened);
    * an unchanged membership is a no-op refresh (None);
    * a changed membership returns a :class:`MembershipChange` AND
      adopts the new set — the caller reacts to the diff (ring swap,
      handoff) exactly once per transition.

    ``injector`` (``resilience/faults.py``) mangles the resolved
    membership with the seeded churn kinds (member_add /
    member_remove / partition) so resize-under-failure soaks
    reproduce."""

    def __init__(self, discoverer: "Discoverer", service_name: str,
                 injector=None):
        self.discoverer = discoverer
        self.service_name = service_name
        self.injector = injector
        self.members: List[str] = []
        self.refreshes = 0
        self.failures = 0
        self.changes = 0

    def refresh(self) -> "Optional[MembershipChange]":
        self.refreshes += 1
        try:
            dests = self.discoverer.get_destinations_for_service(
                self.service_name)
        except Exception as e:
            self.failures += 1
            log.warning("membership refresh failed, keeping %d known: %s",
                        len(self.members), e)
            return None
        if not dests:
            self.failures += 1
            log.warning("discovery returned zero members, keeping %d",
                        len(self.members))
            return None
        if self.injector is not None:
            mangled = self.injector.mangle_members(
                f"discovery.refresh.{self.service_name}", dests)
            # churn must degrade the fleet, never erase it
            dests = mangled or dests
        new = sorted(set(dests))
        if new == self.members:
            return None
        change = MembershipChange(self.members, new)
        self.members = new
        self.changes += 1
        return change


class RetryingDiscoverer:
    """Wrap any discoverer with the shared retry/backoff substrate
    (``resilience/``) so one flaky Consul/k8s API response does
    not cost a refresh cycle. The proxy retries its refresh loop
    directly (proxy._refresh_ring, where the retry count feeds
    /debug/vars); this wrapper is for library users driving a
    discoverer themselves."""

    def __init__(self, inner: "Discoverer", retry_policy=None,
                 budget: float = 10.0, on_retry=None):
        self._inner = inner
        self._policy = retry_policy or RetryPolicy()
        self._budget = budget
        self._on_retry = on_retry
        self.retries = 0

    def get_destinations_for_service(self, service_name: str) -> List[str]:
        def on_retry(retry_index, exc, pause):
            self.retries += 1
            if self._on_retry is not None:
                self._on_retry(retry_index, exc, pause)

        return call_with_retry(
            lambda: self._inner.get_destinations_for_service(service_name),
            self._policy, deadline=Deadline.after(self._budget),
            retryable=(Exception,), on_retry=on_retry)


class ConsulDiscoverer:
    """Healthy-instance query against the Consul HTTP API
    (consul.go:16-55): GET /v1/health/service/{name}?passing, one
    destination per passing instance at http://{address}:{port}."""

    def __init__(self, consul_url: str = "http://127.0.0.1:8500",
                 timeout: float = 10.0, scheme: str = "http"):
        self.base = consul_url.rstrip("/")
        self.timeout = timeout
        self.scheme = scheme

    def get_destinations_for_service(self, service_name: str) -> List[str]:
        url = f"{self.base}/v1/health/service/{service_name}?passing"
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            entries = json.load(resp)
        destinations = []
        for entry in entries:
            svc = entry.get("Service") or {}
            node = entry.get("Node") or {}
            # the service address wins; fall back to the node address
            # (consul.go:43-52)
            address = svc.get("Address") or node.get("Address")
            port = svc.get("Port")
            if not address:
                continue
            if port:
                destinations.append(f"{self.scheme}://{address}:{port}")
            else:
                destinations.append(f"{self.scheme}://{address}")
        return destinations


class KubernetesDiscoverer:
    """In-cluster pod query (kubernetes.go:14-91): list pods labelled
    ``app=veneur-global`` in the current namespace via the API server,
    authenticated with the mounted service-account token."""

    TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
    CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"
    NS_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"

    def __init__(self, timeout: float = 10.0, label: str = "app=veneur-global",
                 pod_port: str = "8127"):
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "not running in a Kubernetes cluster "
                "(KUBERNETES_SERVICE_HOST unset)")
        self.base = f"https://{host}:{port}"
        self.timeout = timeout
        self.label = label
        self.pod_port = pod_port
        with open(self.TOKEN_PATH) as f:
            self._token = f.read().strip()
        self._ctx = ssl.create_default_context(cafile=self.CA_PATH)
        with open(self.NS_PATH) as f:
            self.namespace = f.read().strip()

    def get_destinations_for_service(self, service_name: str) -> List[str]:
        url = (f"{self.base}/api/v1/namespaces/{self.namespace}/pods"
               f"?labelSelector={urllib.parse.quote(self.label)}")
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {self._token}"})
        with urllib.request.urlopen(req, timeout=self.timeout,
                                    context=self._ctx) as resp:
            pods = json.load(resp)
        destinations = []
        for pod in pods.get("items", []):
            status = pod.get("status") or {}
            if status.get("phase") != "Running":
                continue
            ip = status.get("podIP")
            if ip:
                destinations.append(f"http://{ip}:{self.pod_port}")
        return destinations
