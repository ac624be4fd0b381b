#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veneur_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a) and its native
ingest and egress libraries (g++), side by side, then runs eighteen
phases, each printing one JSON line (checkpoint two, capacity eight,
mesh six, grpc_proxy three, fleet_ha five, lifecycle five):

  kernels  K1 drain_quantile and K2 compress_presorted at the flush's
           shape (1,048,576 rows, K=104, the store's 9 quantiles), each
           with the b half presorted and with sort_b (K3), each again at
           compression 1000 (K=1008) on 4,096 rows through the general
           path, and at merge widths 32 and 16 (K=16 at compression 14,
           K=8 at 6: the tiered pool's) on 262,144 rows through the
           narrow path: held against its plain PyTorch version on the
           card, each call's launch counted on its path's counter (the
           wide and narrow ones print the device kernel a call runs),
           then each full call timed beside its bound, and sort_b beside
           the flush's torch.sort + presorted composition;
  store    a MetricStore on cuda with 65,536 histogram series x 8
           samples (the second half of the interval steps the
           distribution, so the shift guard drains through K2) and 32,768
           HLL sets at p=14, then one flush through K1; cut from
           1,048,576 series, since the ingest phase drives the 1M-series
           ingest and flush; then the obs plane's cost on that store's
           flush (the store_obs_cost line: median of 3 columnar flushes
           with a StageRecorder active against 3 without);
  server   the UDP Server with a channel sink and the obs plane:
           datagrams of every ported type, one flush, rows checked
           against what was sent; /debug/flush-timeline (the store's
           stages) and /debug/vars (the kernel scopes' dispatches and
           the CUDA launch counters) read over HTTP; the next flush's
           self-metrics; a /debug/xprof capture over flushes whose
           ingest trips the shift guard, every K1 and K2 device kernel
           in it joined to its veneur.flush.digest.dense or
           veneur.drain.digest.dense range; a twin with obs_enabled
           false that flushes the same rows and answers 404;
  ingest   the server's default UDP listener, the ingest-lane fleet
           (4 lanes, native parse, recvmmsg) of a Server on cuda, at
           262,144 histogram series (1,048,576 until the mesh phase came,
           524,288 until the fleet_ha phase came, to keep the script in
           its time; 2 tags, 8 samples, a quarter at
           @0.5, the last four shifted +1000 so the guard drains through
           K2), 32,768 sets of 16 members, 4,096 counters and gauges,
           256 events and service checks: DogStatsD lines in datagrams of
           at most 1,432 bytes from 2 sender processes x 16 flows, paced
           so the kernel drops nothing; the Server's max_series is
           2,097,152 (at the default 2^20 the group would freeze
           first-sight series at 70%). Two intervals (every series first
           seen, then the same traffic), each flushed through K1 and
           held to the traffic: conservation, counters, gauges, digest
           mass, extrema and percentiles, set estimates, the service
           checks' status rows and the events in flush_other_samples.
           Each flush runs the default shape (columnar, pipelined,
           streaming): a Datadog sink POSTs deflated bodies from the
           native serializer to an in-process receiver on 127.0.0.1,
           which inflates every body (its series count must equal the
           blocks' rows) and parses the first chunk back to its blocks;
           a recording sink keeps the ColumnarFlush, whose arrays are
           checked; the flush wall and its stages are printed. Then a
           4,096-series twin (one lane and the per-line path emit the
           same on the CPU; one lane on cuda agrees with the CPU as the
           kernels do; both flush per row, and a columnar twin on cuda
           archives the same rows through the local-file plugin) and an
           unpaced 5 s burst at 1 and 4 lanes;
  ssf      SSF into a Server on cuda: the native SSF reader pool (4
           readers) and a unix:// SSF listener, indicator_span_timer_name
           set, a channel metric sink and a channel span sink. 131,072
           histogram series (262,144 until the lifecycle phase came; 2
           tags, 8 samples, a quarter at rate 0.5,
           the last four shifted +1000 so the guard drains through K2 on
           the pump's thread) as SSFSamples, 16 a span, plus spans of
           4,096 counters, gauges and sets x 16 members and 1,024 STATUS
           samples (the slow lane); every span an indicator span (64
           services x {error, ok}, 1 us to 10 s); 256 events and service
           checks over statsd. Paced windows from the sender processes;
           one flush through K1. Held to the traffic: every span to the
           span sink, every sample merged (exact conservation), digests,
           timers, counters, gauges, sets, status rows, events. Then a
           4,096-series twin: the Python UDP rung, the UNIX stream and
           the native lane emit the same rows on the CPU, and the native
           lane and the UNIX stream on the card agree with the CPU;
  heavy_hitters
           veneurtopk sets at the default top-k geometry (depth 4,
           width 65,536, K 32): 16,384 series x 32 samples (65,536
           until the fleet_ha phase came, to keep the script in its
           time), members Zipf(1.1) over 65,536 keys; three quarters
           into a Server's lane fleet (4 lanes) beside 16,384 histogram
           series x 8 samples (K2 and K1 in the same flush), the rest
           into a second
           Server's C++ pool and its unix:// SSF listener. Each series'
           emitted top-k is held to an exact count (never under it, over
           it by at most e/w x N but for a share e^-depth, no member in
           hex), with exact conservation; the count-min update is timed
           a drain with CUDA events. Then two locals of 4,096 top-k
           series forward to a global over HTTP in both body formats:
           the fleet top-k is the sum of the locals' within the bound,
           and the reference's (gob) body carries no sketch;
  overload the series cap (max_series 4,096 against 40,000 counter and
           8,192 histogram series: the overflow rows hold every spilled
           sample, veneur.* names pass the freeze), the tag cap (the
           40-tag line and 1,000 like it on the lanes, the C++ pool, the
           Python readers and SSF) and the shed ladder (a span channel
           forced full: spans shed at level 2, statsd datagrams at level
           3, every one counted);
  global_merge
           global aggregation over the JSON body: two forwarding locals
           on cuda (32,768 histogram series each since the lifecycle
           phase came, 65,536 since the capacity phase came, 262,144
           before it and 1,048,576 before the
           native leg, to keep the script inside its time: 1,048,576
           took 174 s of a 627 s run on an NVIDIA H100 80GB HBM3 at
           700 W; native_merge runs the same merge at 1,048,576;
           B's distribution shifted from A's, 32,768 sets in both,
           4,096 global-only counters) and a global that imports both
           states (digests through import_digests_bulk, the rest
           through the JSON body) and flushes; held to conservation, extrema, the union's
           percentiles, counters and set cardinalities, and a 4,096-row
           slice run on cuda and on the CPU twin-checked as the kernels
           are;
  native_merge
           the packed binary forward at full width: the global_merge
           traffic, each local flushed with digest_format="packed" (the
           pack on the card, held bit for bit against its CPU run on
           65,536 rows) and sent by a NativeForwarder over loopback TCP
           into a NativeImportServer on a port global (C++ decode, the
           C++ MetricList table, numpy staging, K2 on the import
           drains), which flushes columnar (K1); held to the same
           checks as global_merge, and printed beside its JSON leg's
           import and flush seconds;
  grpc_proxy
           gRPC forward and import, and the proxy tier. grpc_global: the
           frames native_merge's two locals encoded (1,048,576 packed
           digests, 32,768 sets, 4,096 counters a local) sent again by a
           GRPCForwarder over loopback gRPC into an ImportServer on a
           fresh dense global store (C++ decode, import_columnar, K2 on
           its guard drains; one K2 a guard drain), which flushes (K1);
           its rows equal the native:// global's bit for bit; the import
           split, each local's send (and its wire share, less the
           global's merge), frames and bytes. proxy_tier: two global
           Servers with http_address and grpc_address (dense, and a mesh
           4 x 2 with mesh_hosts 2) behind a Proxy with its HTTP and gRPC
           listeners over a static ring of the two; local A (32,768
           histogram series since the lifecycle phase came, 65,536
           before; 4,096 sets, counters and gauges) forwards
           over gRPC to the proxy's gRPC port, local B (the same names,
           its distribution shifted) over HTTP to its /import, and the
           same two locals forward to a third, dense global directly:
           every series on exactly one of the two globals (so both
           transports routed it to the same one), their union equal to
           the direct global (counters, gauges, extrema, counts and set
           estimates exact, percentiles within rtol 1e-5), every metric
           proxied with no error; each transport's fan-out seconds. The
           fleet trace plane: each local serves its timeline, and the
           globals (fleet_peers: the locals and the proxy) pull it
           before it stops; the dense global's /debug/trace stitches
           the HTTP local's trace through the proxy (local.flush ->
           proxy.fan_out -> global.import -> global.flush, the import
           re-parented under the fan-out) and the direct global's the
           gRPC local's without a proxy hop;
  fleet_trace
           the fleet trace plane at full width: a port local Server (UDP
           lanes, forward_use_grpc) takes 4,096 histogram series x 4
           samples over UDP (each lane chunk carries its ingest stamp)
           and 1,048,576 through its store; a second interval gives
           every 16th series 4 samples shifted +1,000. Each local flush
           forwards its packed digests over gRPC with X-Veneur-Trace in
           the call metadata into a port global Server (obs_enabled,
           fleet_peers naming the local), whose imports park their
           global.import hops (K2 on the guard drains interval 2's
           frames trip) and whose one flush (K1) publishes them. Held:
           each local flush's trace id stitches local.flush ->
           global.import -> global.flush at the global's /debug/trace,
           every import hop under it; the next global flush emits
           veneur.fleet.e2e_age_ns (through self_timers, K1), each
           value between the UDP feed's end and the first send, as
           ages at the global flush's start and end; /debug/fleet
           lists the local fresh, then stale once it stopped; the
           global's K2 and K1 launches counted by window (import,
           flush) beside their kernel scopes' dispatches. Printed: each
           trace's hops and durations, hop_coverage_ratio and e2e wall
           time, the import split, the e2e age's p50 and p99;
  sinks    the remaining sinks and the statsd TCP/TLS listener. Leg
           (a): one port Server configured through sinks/factory.py
           from a Config: a tcp:// statsd listener with TLS and client
           certificates required (tests/data/torch_tls/; the C++ rung,
           or the run fails), an SSF udp:// listener with the indicator
           timer, SignalFx (tags_exclude drop_me), Datadog's trace
           agent, LightStep and Falconer, each an in-process receiver on
           127.0.0.1. 1,048,576 histogram series x 4 samples through its
           store, then 65,536 series x 4 samples (weight 8; the last two
           shifted +1,000, so the guard drains through K2 on the TLS
           pump's thread; every 16th series tagged drop_me) over 8 TLS
           connections with client certificates, after an anonymous
           client and one with an untrusted certificate are refused;
           4,096 indicator spans; one flush (K1). Held: every SignalFx
           datapoint counted by a byte scan equals the flush's rows,
           none carries drop_me, 4,096 sampled series' datapoints parsed
           back equal the ColumnarFlush arrays and carry the host
           dimension; the TLS series' counts, extrema and percentiles
           (within 0.02 x span of the exact digest); 2 handshake
           failures and 8 connections; every span at each span sink.
           Leg (b): a second Server with the Kafka metric and span
           sinks producing over the stdlib wire producer into an
           in-process broker (Metadata v0, Produce v0): 16,384
           histogram series, 1,024 counters, 256 events and 256 service
           checks over plain tcp:// (the C++ rung), 1,024 spans; the
           metric topic holds every row's JSON (status rows included),
           the check and event topics none, each span message decodes
           to the span sent. Printed: the TLS lines a second,
           connections and handshake failures; SignalFx bodies, bytes,
           serialize and POST seconds; the flush's wall; datapoints
           against rows; messages by topic and the produce seconds;
           spans at each sink; K1 and K2 by window;
  fleet_ha the elastic and HA global tier. handoff: a dense global
           Server A with handoff_enabled over a file:// peers file that
           names only A takes native_merge's local A frames over gRPC
           (1,048,576 packed digests, 32,768 sets, 4,096 counters) and
           4,096 global-only gauges and 4,096 veneurtopk series through
           its store; B joins the peers file and A's refresh hands about
           half of the ring to B's POST /handoff. The new ring's own
           traffic (8 samples shifted +5,000 on every 64th series, an
           increment on every 8th counter) goes over UDP to B before the
           resize and to A between its generation swap and its kept
           half's re-merge, so the import drains on both sides meet rows
           holding newer data (K2 on each; the receiver's first K2 held
           to its plain version). A twin C takes the same state and
           traffic and never resizes; it runs, flushes and shuts down
           before A is fed, its launches not counted. Every ring-routed series of A and
           B lies on the owner RingTransition names; A's and B's flushes
           are disjoint and their union is C's (counters, gauges, set
           estimates, digest counts and extrema equal, percentiles within
           0.02 x span of C's: the pack's u16 means; the top-k rows
           equal C's and within the count-min bound, the table having
           gone whole with each part); a second POST of the same handoff
           acks as a duplicate and merges nothing; B's /debug/trace
           holds A's handoff.send entry and its own handoff.receive hop
           under one trace id. Printed: the
           extraction split (swap and snapshot, ring split, kept
           re-merge), pack and encode, wire bytes, the POST until the
           ack, B's merge, moved series, K2 on each side. standby: an
           active and a standby global over a file:// lease (ttl 1 s), a
           local forwarding 65,536 histogram series, 4,096 sets,
           counters and gauges over native:// for two intervals; each
           flush replicates, held in the standby's shadow off its live
           store; the active is killed holding the lease (crash_stop),
           a local re-routes every 16th series' next samples to the
           standby, whose elector wins after the ttl and whose promotion
           (waiting for them, so its import drains run K2, the first
           held to its plain version) merges every group but the
           counters; its digest mass equals the shadow's (plus the
           re-routed samples), its flush emits no replicated counter,
           the active's last gauges and set estimates, and percentiles
           within rtol 1e-5 of the active's last flush; a replicate
           carrying the deposed lease epoch gets 409; the active's
           flushes emit veneur.ha.*, and the standby's next flush counts
           the two traced replicate hops in veneur.trace.hops_total.
           Printed: the
           replication's seconds and bytes an epoch, kill -> leader,
           kill -> the first promoted flush. mesh_tiered: a
           MetricStore(digest_storage="tiered") on the 4 x 2 shard mesh
           and a single-card tiered twin, 524,288 histogram series
           (two pool slabs; 1,048,576 until the sinks phase came, to keep
           the script in its time), two intervals of 8 samples a series (the last four shifted
           +1,000: the pool guard drains), one 8-centroid import run a
           series and 128 samples on every 64th series (promoted in the
           second interval): counts and digest mass exact on both, the
           same promotions. Each store's pool guard drains are logged
           against its staging drains, which gives each series its drain
           schedule: a series with the twin's schedule that stayed in
           the pool has percentiles within rtol 1e-5 of the twin's (the
           share bit for bit printed); the others (the mesh's pool slabs
           hold other series than the twin's, so their guard drains fall
           elsewhere; the promoted series, whose bank bins a chunk's host
           slices apart) have rank errors against each row's exact
           samples no worse than the twin's (the mean within 5%, at most
           a share 1e-4 more than bench.py 2g's 0.15 past the twin's);
           the twin's launches do not count; the sharded pool's first
           compaction held to
           its plain version at max abs error 0.0 and named
           narrow_rows_kernel<16, ...> by the launcher. Printed: shard
           occupancy and balance, staging and flush seconds, peak device
           memory, launches by path. mesh_tiered_server: a mesh tiered
           Server (4 x 2) takes 65,536 histogram series x 8 samples over
           UDP and flushes every count exact;
  mesh     the mesh-sharded global tier on a 4 x 2 shard mesh (the
           card eight times: series shards are row blocks of one plane,
           the hosts axis a leading dimension): GlobalAggregator.step at
           1,048,576 series (2 hosts x 16,777,216 samples, 2 x 1,048,576
           set members at p=14 and counter increments; counters exact,
           registers bit for bit one device's scatter-max, digest mass
           exact, the dryrun's quantiles of every 5th row against
           np.quantile); merge_forwarded_digests at 1,048,576 rows and
           hosts 2 (one butterfly round: K2 with both halves ascending,
           held to its plain version, mass exact, timed beside its
           bound); a mesh global Server (mesh_enabled, mesh_hosts 2) fed
           over native:// the two states native_merge's locals sent, its
           flush held to native_merge's dense global (percentiles rtol
           1e-5, counts, extrema, counters and set estimates equal; the
           import split, shard occupancy and balance ratio printed); a
           mesh store's checkpoint at 16,384 series (65,536 until the
           sinks phase came, 32,768 until the lifecycle phase came)
           restored into a mesh
           and a dense store, which flush the same rows; rung 3 on a
           mesh group at 16,384 series;
  server_global
           a global Server (http_address) and a local Server (UDP in,
           forward_address) in this process: 65,536 series forwarded
           with streaming on (the histogram group POSTs as a deflated
           /import part of its own, the rest as a second), merged by
           the global's pool and flushed into a channel sink, in our
           body format and in the reference's (gob/axiomhq); then the
           same over native:// into native_import_address, with packed
           digests and with forward_packed_digests false;
  checkpoint
           crash-safe state: a Server on cuda with
           checkpoint_interval 1s (the file in build/, on local disk)
           takes 262,144 histogram series x 8 samples (1,048,576 until
           the capacity phase came, to keep the script in its time;
           the last four
           shifted +1000: K2 on ingest), 32,768 sets x 16 members, 4,096
           counters and gauges and 4,096 veneurtopk series x 16 members
           through the store API; once a committed checkpoint covers all
           of it the Server is killed (crash_stop) and a second Server on
           the same path restores it (deserialize, intern, import drains)
           and flushes columnar (K1, held to its plain version on the
           same tensors). Held to an uninterrupted twin store: counters,
           gauges and set estimates equal, digest counts and total weight
           exact, sum/min/max within rel 1e-4, percentiles within 0.02 x
           span, top-k rows equal; the checkpoint gone after the flush.
           The line splits the checkpoint write (lock, fetch, flatten,
           serialize, write+fsync, bytes) and the restore; K2 on
           ingest and K1 at the restored flush are held to their plain
           versions. Then compute_ladder at 65,536 series: a kernel
           fault at preflight (a FaultInjector) launches nothing and
           re-merges the interval (rung 3), which the next flush emits
           through K1, held to a twin that never failed; the breaker
           opening (flushes re-merge without a launch, the staging
           drains stay on K2) and its probe closing it on an injected
           clock; and a fetch fault while the next interval arrives
           (the re-merge trips the guard, K2 held to its plain version;
           every count emitted at the next flush).
  capacity the slab and tiered digest stores (digest_storage: slab |
           tiered) at the JAX package's own capacity-plan sizes
           (bench.py's lanes, their sizes copied here): slab_4m, a
           local SlabDigestBank of 4,194,304 series in float32 over
           1M-row slabs, 8 chunks of one gamma(2, 50) sample a row a
           slab (2_histo_4m); slab_10m_bf16, 10,485,760 series stored
           bfloat16 over 262,144-row slabs, 4 chunks (2b_histo_10m_bf16);
           merge_10m_bf16, the merge role at 10,485,760 series bfloat16,
           one batch of sorted [slab, 104] centroids a slab through K2
           (2c_merge_global_10m); tiered_10m, a TieredDigestGroup of
           10,485,760 series over 262,144-row pool slabs, 4 cold samples
           a series and 10,000 hot series x 40 more (promote_samples 32,
           promote_intervals 1: they take dense slots mid-interval), the
           pool compacting through K2 at merge width 32 on the narrow path
           (2g_tiered_10m).
           Each prints its staging and flush walls (median of 2; 3
           until the sinks phase came, to keep the script in its time),
           torch.cuda.max_memory_allocated, its K1/K2 launches, the
           first launch of each new shape held to its plain version
           (K1 on slabs upcast from bfloat16, K2 in the merge role and at
           width 32), every count exact, and 2,048 sampled rows against
           a dense DigestGroup fed them identically (bench.py 2g's
           merged_ok: the excess rank error at most 0.15). Then three
           Servers on the UDP lane at 16,384 histogram series (65,536
           until the sinks phase came, 32,768 until the lifecycle phase
           came; dense,
           slab with bfloat16 digests, tiered; the same datagrams), the
           slab and tiered rows held to the dense twin's; a checkpoint
           written by a slab store and restored into a tiered one, and
           rung 3 (a preflight fault, the re-merge, the late flush) on a
           slab and a tiered store, held to twins that never failed,
           both at 16,384 series.
  lifecycle
           the reload, the upgrade, the client CLIs and the fault hooks.
           reload: a Server built through sinks/factory.py, a Datadog
           sink at in-process receiver A, percentiles 0.5 and 0.99;
           1,048,576 histogram series x 4 gamma(2, 10) samples through
           its store and a flush (K1); Server.reload with four
           percentiles, one more tag, the sink at receiver B and a
           changed tdigest_compression (frozen: it warns and stays); the
           same series again and a flush (K1 with the new count). Held:
           B gets every row, every series the four percentile columns,
           every row the new tag, A nothing more; 4,096 series'
           percentiles within 0.02 x (max - min) of the exact digest of
           their samples (the rank error against np.quantile printed);
           A's sink closed at the next reload, not before; the statsd
           socket the same. cli: the server CLI as a process on the
           card (fixed ports, interval 600 s, a Datadog
           sink at an in-process receiver; first a probe that times a
           child's torch import, CUDA context and library loads) takes
           65,536 counter and 65,536 histogram series over UDP, emit's
           metrics, event, service check, -ssf span and -command timing,
           and a prometheus collect of 1,000 families; SIGHUP re-reads
           the file (new percentiles) with the sockets bound; SIGUSR2
           starts generation 2 beside it, generation 1 drains (its
           final flush, K1) and exits 0, generation 2 takes 65,536
           counters and 4,096 histogram series and flushes at SIGTERM.
           Held: every counter exact on its side of the handoff, the
           histogram counts, the new percentile rows, the emitted rows;
           the overlap's datagrams and the kernel's drops printed, not
           gated; SIGUSR2 -> ready and ready -> exit printed.
           forward_faults: two locals of 65,536 histogram series x 8
           (the second shifted +1,000) forward over HTTP to a global
           under 30% http_5xx, connect and timeout faults (one seed,
           retries enough); the same bodies fault-free to a twin
           (uncounted); the global's import drains run K2 and its
           flush K1; its rows bit for bit the twin's, no forward error,
           the injected faults and retries printed. ingest_faults: a
           Server on the per-datagram Python path with truncate and
           burst at 0.1 takes 65,536 datagrams (a counter and a
           histogram line each, 4,096 series, the second half shifted:
           K2), paced with no kernel drop; the same seeded schedule
           replayed on the same datagrams: every counter's sum, every
           histogram's count and the rejected lines equal the replay's.

The ingest phase also prints its flushes' timeline (ingest_timeline:
the stage tree, the lanes' ingest.* stages and the seal->merge
latencies), and a 1 s capture at the end (late_capture) says whether a
trace that late holds device events.

After every phase every store it built must show requeued_total and
lost_total at 0 (the compute_ladder store and the rung-3 stores of
capacity and mesh excepted), so a run in which the kernel ever gave way
fails.

The launch counts in the kernel summary are the sum over the store,
ingest (its two intervals), ssf (its main path), heavy_hitters (its two
Servers), overload (the series cap's flush), global_merge, native_merge,
grpc_proxy (its globals and locals), fleet_trace (its local and
global), sinks (both Servers' main paths), fleet_ha (its four legs, the twins excepted), mesh,
server_global, checkpoint
(the kill and restart, and the ladder),
capacity (its oracles and plain-version holds excepted) and lifecycle
phases (the in-process legs; the CLI generations' launches are
theirs, and the faulted forward's twin is uncounted); the
summary's butterfly row counts the mesh phase's butterfly K2 alone, and
its width-32, width-16 and general-path rows the launches that took
those paths (a share of K1's and K2's rows). K2 at width 32 is timed on
the capacity phase's pool compaction inputs, and that phase prints the
device function the compaction launched (the launcher's record). It
ends with the kernel summary, the card's name and power limit, and
{"ok": true, "device": {...}} as the last line. Any failed check raises
and the script exits non-zero; without a CUDA device it exits 2 before
printing any result. It imports nothing of the JAX package.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np

SEED = 20261017
ROWS = 1 << 20                   # histogram series (README "Scale")
SAMPLES_PER_SERIES = 8
SET_SERIES = 1 << 15
STORE_ROWS = 1 << 16             # the store phase's series (see above)
PERCENTILES = (0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99)
COMPRESSION = 100.0
WIDE_COMPRESSION = 1000.0        # K=1008, merge width 2048: general path
WIDE_ROWS = 4096
# the narrow path: (label, compression) at merge width 32 (K=16, the
# tiered pool's compaction at tier_pool_centroids 16) and 16 (K=8, at 8),
# on one pool slab of rows
NARROW = (("w32_", 14.0), ("w16_", 6.0))
NARROW_ROWS = 1 << 18
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 peak
TIMED_LAUNCHES = 20
PLAIN_RUNS = 3
NATIVE_TWIN_ROWS = 1 << 16       # native_merge's pack twin: rows compared
GLOBAL_MERGE_ROWS = 1 << 15      # the JSON leg's series a local (see above)
_RECORDS = {}                    # phase records a later phase reports


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _random_halves(rows: int, k: int, dev, gen):
    """Two row-ascending centroid halves like the flush sees: the digest
    half ~60% live, the temp half ~50% live with +inf empties last."""
    import torch

    def half(scale, frac):
        mean = torch.sort(torch.empty((rows, k), device=dev)
                          .exponential_(1.0 / scale, generator=gen), 1).values
        live = torch.rand((rows, k), device=dev, generator=gen) < frac
        w = torch.randint(1, 5, (rows, k), device=dev, generator=gen,
                          dtype=torch.int32).float() * live
        return mean, w

    ma, wa = half(30.0, 0.6)
    mb, wb = half(25.0, 0.5)
    mb = torch.where(wb > 0, mb, math.inf)
    mb, order = torch.sort(mb, 1)
    wb = torch.gather(wb, 1, order)
    big = torch.finfo(torch.float32).max
    mn = torch.minimum(torch.where(wa > 0, ma, big).amin(1),
                       torch.where(wb > 0, mb, big).amin(1))
    mx = torch.maximum(torch.where(wa > 0, ma, -big).amax(1),
                       torch.where(wb > 0, mb, -big).amax(1))
    return ma, wa, mb, wb, mn, mx


def _compare(name, got, want, wa, wb, span=None) -> float:
    """Kernel vs plain: per-row mass rtol 1e-6, identical bin liveness,
    live bin weights and means rtol 1e-5 (the same arithmetic; only the
    order of the per-bin sums may differ), percentiles within 1e-4 x span,
    and every compared value within 1e-4 absolute. Returns the largest
    absolute difference over the compared values."""
    import torch

    gm, gw = got[0], got[1]
    pm, pw = want[0], want[1]
    mass = wa.double().sum(1) + wb.double().sum(1)
    mass_err = ((gw.double().sum(1) - mass).abs()
                / mass.clamp_min(1e-30)).max().item()
    if mass_err > 1e-6:
        raise AssertionError(f"{name}: row mass off by {mass_err:.3g}")
    live = pw > 0
    if not torch.equal(gw > 0, live):
        raise AssertionError(f"{name}: bin liveness differs from plain")
    dw, dm = (gw - pw).abs()[live], (gm - pm).abs()[live]
    w_err = (dw / pw[live].abs().clamp_min(1e-30)).max().item()
    m_err = (dm / pm[live].abs().clamp_min(1e-30)).max().item()
    if w_err > 1e-5 or m_err > 1e-5:
        raise AssertionError(f"{name}: live bins off (w {w_err:.3g}, "
                             f"mean {m_err:.3g})")
    worst = max(dw.max().item(), dm.max().item())
    if span is not None:
        gp, pp = got[2], want[2]
        if not torch.equal(torch.isnan(gp), torch.isnan(pp)):
            raise AssertionError(f"{name}: NaN percentiles differ")
        dp = torch.nan_to_num((gp - pp).abs(), nan=0.0)
        p_err = (dp / span[:, None].clamp_min(1e-30)).max().item()
        if p_err > 1e-4:
            raise AssertionError(f"{name}: percentiles off by {p_err:.3g} "
                                 "of the row span")
        worst = max(worst, dp.max().item())
    if worst > 1e-4:
        raise AssertionError(f"{name}: max abs error {worst:.3g} > 1e-4")
    return worst


# tdigest_cuda.COUNTERS: launches by mode, then (a share of those) by path
_COUNTERS = ("launches", "sort_b_launches", "narrow16_launches",
             "narrow32_launches", "general_launches")
_PATH_KERNEL = {"narrow": "narrow_rows_kernel", "warp": "warp_rows_kernel",
                "general": "block_rows_kernel"}


def _reset_counts(tc) -> None:
    for fn in (tc.drain_quantile, tc.compress_presorted):
        for c in _COUNTERS:
            setattr(fn, c, 0)


def _counts(tc) -> dict:
    return {f"{fn.__name__}.{c}": getattr(fn, c)
            for fn in (tc.drain_quantile, tc.compress_presorted)
            for c in _COUNTERS}


class _uncounted:
    """Within the block, launches do not count toward the main path's:
    the counts are put back as they were before it (a twin or a
    reference driven beside the main path, with nothing of the main
    path in flight)."""

    def __init__(self, tc):
        self.tc = tc

    def __enter__(self):
        self.before = _counts(self.tc)
        return self

    def __exit__(self, *exc):
        for fn in (self.tc.drain_quantile, self.tc.compress_presorted):
            for c in _COUNTERS:
                setattr(fn, c, self.before[f"{fn.__name__}.{c}"])


def _device_kernels(fn):
    """Names of the device kernels one call of fn runs, from a
    torch.profiler trace; None when the trace holds no device events
    (the profiler could not trace the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return names or None


def _bound(nbytes, ops):
    """The least time the card could take: bytes over the HBM rate or
    operations over the fp32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _work(rows, ka, kb, kout, nq, sort_b, drain):
    """Bytes the function must move (each input read once at its own
    width, each output written once) and the operations it does, counted
    from the algorithm: L*log2(L)/2 merge compare-exchanges (3 ops each),
    with sort_b half*log2(half)*(log2(half)+1)/4 more, m*ceil(log2 m)
    scan adds, ~26 binning and reduce ops per merged slot, and for K1
    the quantile pass (3 log-step scans over K plus P*K compares)."""
    f32 = 4
    half = 1 << (max(ka, kb) - 1).bit_length()
    L, m = 2 * half, ka + kb
    nbytes = f32 * rows * (2 * ka + 2 * kb + 2 * kout)
    lg = int(math.log2(L))
    ops = rows * (3 * L * lg // 2 + m * math.ceil(math.log2(m)) + 26 * m)
    if sort_b:
        lh = int(math.log2(half))
        ops += rows * 3 * half * lh * (lh + 1) // 4
    if drain:
        nbytes += f32 * (2 * rows + nq + rows * nq)
        ops += rows * (3 * kout * math.ceil(math.log2(kout)) + nq * kout)
    return nbytes, ops


def _shuffled(mb, wb, gen):
    """The b half in a random order per row (the sort_b input)."""
    import torch

    perm = torch.argsort(torch.rand(mb.shape, device=mb.device,
                                    generator=gen), 1)
    return torch.gather(mb, 1, perm), torch.gather(wb, 1, perm)


def phase_kernels(dev, rows: int = ROWS, wide_rows: int = WIDE_ROWS,
                  narrow_rows: int = NARROW_ROWS):
    """Every kernel instance against its plain version on the card: K1
    and K2 at the flush's shape, each with the b half presorted and with
    sort_b (K3), the general path at compression 1000 on a few thousand
    rows, and the narrow path at merge widths 32 and 16 on a pool slab of
    rows; then each full call timed beside its bound, and sort_b beside
    the flush's own composition (torch.sort of the temp half, then the
    presorted kernel). Each call must count one launch on its path's
    counter, and the wide and narrow instances print the device kernel
    one call runs."""
    import torch

    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    qs = torch.tensor(list(PERCENTILES) + [0.5], dtype=torch.float32,
                      device=dev)
    nq = qs.shape[0]
    out, calls = {}, {}
    for label, c, n in (("", COMPRESSION, rows),
                        ("wide_", WIDE_COMPRESSION, wide_rows),
                        *((lb, cn, narrow_rows) for lb, cn in NARROW)):
        k = td.size_bound(c)
        path = tc.kernel_path(tc.next_pow2(k), k)
        on_path = {"narrow": f"narrow{2 * tc.next_pow2(k)}_launches",
                   "general": "general_launches"}.get(path)
        ma, wa, mb, wb, mn, mx = _random_halves(n, k, dev, gen)
        mb_u, wb_u = _shuffled(mb, wb, gen)
        span = (mx - mn).float()
        for sort_b in (False, True):
            b = (mb_u, wb_u) if sort_b else (mb, wb)
            tag = label + ("sort_b_" if sort_b else "")

            def k1(b=b, sort_b=sort_b, c=c, k=k):
                return tc.drain_quantile(ma, wa, *b, mn, mx, qs, c, k,
                                         sort_b=sort_b)

            def k2(b=b, sort_b=sort_b, c=c, k=k):
                return tc.compress_presorted(ma, wa, *b, c, k,
                                             sort_b=sort_b)

            def k1_plain(b=b, sort_b=sort_b, c=c, k=k):
                return tc.drain_quantile_plain(ma, wa, *b, mn, mx, qs, c, k,
                                               sort_b=sort_b)

            def k2_plain(b=b, sort_b=sort_b, c=c, k=k):
                return tc.compress_presorted_plain(ma, wa, *b, c, k,
                                                   sort_b=sort_b)

            counters = [x for x in ("sort_b_launches" if sort_b
                                    else "launches", on_path) if x]
            for name, fn, plain, sp in (
                    ("drain_quantile", k1, k1_plain, span),
                    ("compress_presorted", k2, k2_plain, None)):
                wrapper = getattr(tc, name)
                before = [getattr(wrapper, x) + 1 for x in counters]
                got = fn()
                if [getattr(wrapper, x) for x in counters] != before:
                    raise AssertionError(f"{tag}{name}: the call did not "
                                         f"count one launch ({path} path)")
                want = plain()
                torch.cuda.synchronize()
                err = _compare(tag + name, got, want, wa, wb, sp)
                del got, want
                nbytes, ops = _work(n, k, k, k, nq, sort_b,
                                    name == "drain_quantile")
                bound_ms, by = _bound(nbytes, ops)
                out[tag + name] = {"rows": n, "k": k, "max_abs_err": err,
                                   "bytes": nbytes, "ops": ops,
                                   "bound_ms": bound_ms, "bound_by": by}
                if label:
                    out[tag + name]["device_kernels_per_call"] = \
                        _one_kernel(tag + name, fn, path)
                calls[tag + name] = (fn, plain)
        if not label:
            _add_composition(calls, out, tc, ma, wa, mb_u, wb_u, mn, mx, qs)
        # timed inside the loop: the closures read this iteration's inputs
        for name, (fn, plain) in calls.items():
            rec = out.setdefault(name, {})
            rec["ms"] = _median_ms(fn, TIMED_LAUNCHES)
            if plain is not None:
                rec["plain_ms"] = _median_ms(plain, PLAIN_RUNS, warmup=1)
        calls.clear()
    emit({"phase": "kernels", "nq": nq, **out})
    return out


def _one_kernel(name, fn, path):
    """The device kernels one call of fn runs (a profiler trace): one, of
    the path's kernel, or None where the trace holds no device events."""
    kernels = _device_kernels(fn)
    if kernels is not None and (len(kernels) != 1
                                or _PATH_KERNEL[path] not in kernels[0]):
        raise AssertionError(f"{name}: one call ran {kernels}, not one "
                             f"{_PATH_KERNEL[path]}")
    return kernels


def _add_composition(calls, out, tc, ma, wa, mb_u, wb_u, mn, mx, qs):
    """The flush's composition on the unsorted temp half beside sort_b,
    and the check that one wrapper call runs one device kernel."""
    import torch

    from veneur_tpu_torch.ops import tdigest as td

    k = td.size_bound(COMPRESSION)

    def sorted_b():
        sm, order = torch.sort(mb_u, dim=-1)
        return sm, torch.gather(wb_u, -1, order)

    # ops/tdigest.py: _sorted_temp_half, then drain_quantile / drain_temp
    calls["compose_drain_quantile"] = (lambda: tc.drain_quantile(
        ma, wa, *sorted_b(), mn, mx, qs, COMPRESSION, k), None)
    calls["compose_compress_presorted"] = (lambda: tc.compress_presorted(
        ma, wa, *sorted_b(), COMPRESSION, k), None)
    # one call runs one kernel: no pad, flip or cummax passes
    for name in ("drain_quantile", "compress_presorted",
                 "sort_b_drain_quantile", "sort_b_compress_presorted"):
        out[name]["device_kernels_per_call"] = _one_kernel(
            name, calls[name][0], "warp")


def _digest_reference(samples: np.ndarray, qs) -> np.ndarray:
    """Quantiles of a merging t-digest whose centroids are exactly these
    equal-weight samples (merging_digest.go:297-354), in float64 numpy."""
    x = np.sort(samples.astype(np.float64))
    n = len(x)
    ub = np.append((x[:-1] + x[1:]) / 2.0, x[-1])
    out = []
    for q in qs:
        target = q * n
        i = min(int(np.searchsorted(np.arange(1, n + 1), target)), n - 1)
        lb = x[0] if i == 0 else max(ub[i - 1], x[0])
        out.append(lb + (target - i) * (ub[i] - lb))
    return np.array(out)


def _hll_reference(hashes: np.ndarray, p: int) -> float:
    """Classic HLL estimate of one set's uint64 hashes in numpy (float64):
    register = max(leading zeros of the low 64-p bits + 1)."""
    m = 1 << p
    idx = (hashes >> np.uint64(64 - p)).astype(np.int64)
    rest = (hashes << np.uint64(p)).astype(np.uint64)
    rho = np.full(len(hashes), 64 - p + 1, np.int64)
    nz = rest != 0
    lz = 63 - np.floor(np.log2(rest[nz].astype(np.float64))).astype(np.int64)
    # float64 log2 can round up just below a power of two: fix it exactly
    top = np.uint64(1) << (np.uint64(63) - lz.astype(np.uint64))
    lz = np.where(rest[nz] < top, lz + 1, lz)
    rho[nz] = np.minimum(lz + 1, 64 - p + 1)
    regs = np.zeros(m, np.int64)
    np.maximum.at(regs, idx, rho)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)))
    zeros = int((regs == 0).sum())
    if est <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return est


def phase_store(dev, rows: int = ROWS, set_series: int = SET_SERIES,
                chunk: int = 1 << 14):
    """The dense store at deployment size: ingest (K2 on the guard drain)
    and one flush (K1). Returns the launch counts of this phase."""
    import torch

    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
    from veneur_tpu_torch.samplers.parser import MetricKey

    rng = np.random.default_rng(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    store = MetricStore(initial_capacity=1024, chunk=chunk, device=dev)
    hist, sets = store.histograms, store.sets
    t0 = time.perf_counter()
    for i in range(rows):
        hist.interner.intern(MetricKey(f"h.{i}", "histogram", ""), [])
    hist.ensure_capacity(rows - 1)
    for i in range(set_series):
        sets.interner.intern(MetricKey(f"s.{i}", "set", ""), [])
    sets.ensure_capacity(set_series - 1)
    intern_s = time.perf_counter() - t0

    # 8 samples per series at sample rate 0.5 (weight 2): four from a
    # gamma(2, 10) distribution, then four from one shifted past its
    # support by +1000, row-major so each chunk carries whole rows
    half = SAMPLES_PER_SERIES // 2
    early = rng.gamma(2.0, 10.0, (rows, half)).astype(np.float32)
    late = (1000.0 + rng.gamma(2.0, 10.0, (rows, half))).astype(np.float32)
    row_ids = np.repeat(np.arange(rows, dtype=np.int32), half)
    wts = np.full(rows * half, 2.0, np.float32)
    set_card = rng.integers(100, 3001, set_series)
    set_rows = np.repeat(np.arange(set_series, dtype=np.int32), set_card)
    set_hashes = rng.integers(0, np.iinfo(np.uint64).max, len(set_rows),
                              dtype=np.uint64, endpoint=True)

    # where the flush's time goes: the histogram group's dispatch (host
    # enqueue; CUDA events around it give the device time of the flush
    # program), its collect (device->host fetch) and the per-row
    # InterMetric emission, timed around the store's own methods
    spans = {"dispatch_s": 0.0, "collect_s": 0.0, "emit_s": 0.0}
    events = []

    def timed(name, fn, record=False):
        def run(*args, **kwargs):
            t = time.perf_counter()
            if record:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            try:
                return fn(*args, **kwargs)
            finally:
                if record:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                spans[name] += time.perf_counter() - t
        return run

    hist._flush_dispatch = timed("dispatch_s", hist._flush_dispatch, True)
    hist._flush_collect = timed("collect_s", hist._flush_collect)
    store._emit_digest_result = timed("emit_s", store._emit_digest_result)

    _reset_counts(tc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with store._lock:
        hist.sample_many(row_ids, early.reshape(-1), wts)
        hist.sample_many(row_ids, late.reshape(-1), wts)
        hist._drain_samples()
    torch.cuda.synchronize()
    hist_ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with store._lock:
        sets.sample_many(set_rows, set_hashes)
        sets._drain_samples()
    torch.cuda.synchronize()
    set_ingest_s = time.perf_counter() - t0
    k2_ingest = tc.compress_presorted.launches
    k1_ingest = tc.drain_quantile.launches

    t0 = time.perf_counter()
    flushed, _ = store.flush(list(PERCENTILES),
                             HistogramAggregates.from_names(["min", "max",
                                                             "count"]), 0)
    flush_s = time.perf_counter() - t0
    final = flushed.to_intermetrics()
    torch.cuda.synchronize()
    flush_program_ms = events[0].elapsed_time(events[1])
    counts = _counts(tc)
    k1 = tc.drain_quantile.launches
    k2 = tc.compress_presorted.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if k2_ingest < 1 or k1_ingest != 0:
        raise AssertionError(f"ingest launched K2 {k2_ingest}x, K1 "
                             f"{k1_ingest}x; want K2 >= 1, K1 0")
    if k1 < 1:
        raise AssertionError("the flush did not launch K1")

    by = {(m.name): m.value for m in final}
    expect_rows = rows * (3 + len(PERCENTILES)) + set_series
    if len(final) != expect_rows:
        raise AssertionError(f"{len(final)} rows flushed, want "
                             f"{expect_rows}")
    # With 8 samples a series' digest holds every sample as its own
    # centroid, so its percentiles are known exactly: the check holds
    # them to that. Their rank error against np.quantile is reported, not
    # bounded: at n=8 the two interpolation rules alone differ by several
    # hundredths of rank, more than the 0.02 a large-n digest keeps.
    pick = rng.choice(rows, min(512, rows), replace=False)
    worst = rank_worst = 0.0
    for i in pick:
        samples = np.concatenate([early[i], late[i]])
        got = np.array([by[f"h.{i}.{int(p * 100)}percentile"]
                        for p in PERCENTILES])
        want = _digest_reference(samples, PERCENTILES)
        span = float(samples.max() - samples.min())
        err = float(np.max(np.abs(got - want))) / span
        worst = max(worst, err)
        srt = np.sort(samples.astype(np.float64))
        ranks = np.interp(got, srt, np.linspace(0.0, 1.0, len(srt)))
        rank_worst = max(rank_worst, float(np.max(np.abs(
            ranks - np.array(PERCENTILES)))))
        if by[f"h.{i}.count"] != 2.0 * SAMPLES_PER_SERIES \
                or by[f"h.{i}.min"] != samples.min() \
                or by[f"h.{i}.max"] != samples.max():
            raise AssertionError(f"h.{i}: count/min/max wrong")
    if worst > 1e-3:
        raise AssertionError(f"percentiles off the exact digest by "
                             f"{worst:.3g} of the span")
    est = np.array([by[f"s.{i}"] for i in range(set_series)])
    rel = np.abs(est - set_card) / set_card
    starts = np.concatenate([[0], np.cumsum(set_card)])
    ref_err = 0.0
    for i in rng.choice(set_series, min(512, set_series), replace=False):
        ref = _hll_reference(set_hashes[starts[i]:starts[i + 1]],
                             store.hll_precision)
        ref_err = max(ref_err, abs(est[i] - ref) / ref)
    # 1e-4: the port rounds m/zeros to float32 before the log, as the JAX
    # package does; at ~100 members that alone moves the estimate ~1e-5
    if ref_err > 1e-4:
        raise AssertionError(f"set estimates off the numpy HLL by "
                             f"{ref_err:.3g}")
    if np.percentile(rel, 99) > 0.02 or rel.max() > 0.05:
        raise AssertionError(f"set estimates too far from the true "
                             f"cardinality: p99 {np.percentile(rel, 99):.3g}"
                             f", max {rel.max():.3g}")
    emit({"phase": "store", "histogram_series": rows,
          "samples": int(2 * len(row_ids)), "set_series": set_series,
          "set_members": int(len(set_rows)), "chunk": chunk,
          "intern_s": intern_s, "histogram_ingest_s": hist_ingest_s,
          "set_ingest_s": set_ingest_s, "flush_s": flush_s,
          "flush_program_device_ms": flush_program_ms, **spans,
          "rows_flushed": len(final),
          "max_memory_allocated": int(peak),
          "launches": counts,
          "pct_err_vs_exact_digest": worst,
          "rank_err_vs_np_quantile_max": rank_worst,
          "set_err_vs_numpy_hll": ref_err,
          "set_rel_err_p50": float(np.median(rel)),
          "set_rel_err_p99": float(np.percentile(rel, 99))})
    with _uncounted(tc):
        emit({"phase": "store_obs_cost", "card": card_line(),
              **_plane_cost(dev, rows, row_ids, early, late, wts, chunk)})
    return counts


def _plane_cost(dev, rows, row_ids, early, late, wts, chunk,
                rounds: int = 3) -> dict:
    """The obs plane's cost on a store flush: the store phase's histogram
    traffic into a fresh store, flushed columnar (the Server's default;
    device-synced, after a collection) under an active StageRecorder
    (its scopes, stages and the interval-end merge) and, in turn,
    without one, the order alternating a round; the median of
    ``rounds`` each."""
    import torch

    from veneur_tpu_torch import obs
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
    from veneur_tpu_torch.samplers.parser import MetricKey

    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    walls = {"with_recorder_s": [], "without_s": []}
    for r in range(rounds):
        for key in (sorted(walls) if r % 2 else sorted(walls)[::-1]):
            store = MetricStore(initial_capacity=1024, chunk=chunk,
                                device=dev)
            hist = store.histograms
            for i in range(rows):
                hist.interner.intern(MetricKey(f"h.{i}", "histogram", ""),
                                     [])
            hist.ensure_capacity(rows - 1)
            with store._lock:
                hist.sample_many(row_ids, early.reshape(-1), wts)
                hist.sample_many(row_ids, late.reshape(-1), wts)
                hist._drain_samples()
            torch.cuda.synchronize()
            gc.collect()
            rec = obs.StageRecorder() if key == "with_recorder_s" else None
            t0 = time.perf_counter()
            with obs.activate(rec):
                store.flush(list(PERCENTILES), aggs, 0, columnar=True)
            if rec is not None:
                rec.finish()
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
            del store, hist
    out = {k: float(np.median(v)) for k, v in walls.items()}
    out["rounds"] = walls
    out["cost_s"] = out["with_recorder_s"] - out["without_s"]
    return out


def _server_lines(rng, series: int, lines_per_series: int):
    """The server phase's DogStatsD lines of every ported type, and what
    they carry: counter totals, histogram samples, set members."""
    counters, hists, members = {}, {}, {}
    lines = []
    kinds = ("c", "g", "h", "ms", "s")
    for n in range(lines_per_series):
        for i in range(series):
            kind = kinds[i % len(kinds)]
            scope = ("", "|#veneurlocalonly", "|#veneurglobalonly",
                     "|#env:smoke")[(i // len(kinds)) % 4]
            name = f"srv.{kind}.{i}"
            if kind == "c":
                v = int(rng.integers(1, 10))
                counters[name] = counters.get(name, 0) + v
                lines.append(f"{name}:{v}|c{scope}")
            elif kind == "g":
                lines.append(f"{name}:{n}|g{scope}")
            elif kind in ("h", "ms"):
                v = float(rng.gamma(2.0, 10.0))
                hists.setdefault(name, []).append(np.float32(v))
                lines.append(f"{name}:{v!r}|{kind}{scope}")
            else:
                member = f"m{rng.integers(0, 50)}"
                members.setdefault(name, set()).add(member)
                lines.append(f"{name}:{member}|s{scope}")
    return lines, counters, hists, members


def _send_lines(port: int, lines) -> None:
    """Datagrams of 8 lines, paced (2 ms every 16 datagrams): a lane
    sheds whole receive batches once its backlog of sealed chunks
    reaches its cap."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(lines), 8):
            tx.sendto("\n".join(lines[i:i + 8]).encode(),
                      ("127.0.0.1", port))
            if i % 128 == 0:
                time.sleep(0.002)


def _wait_processed(server, n: int, timeout: float = 60.0) -> None:
    deadline = time.time() + timeout
    while server.store.processed < n:
        if time.time() > deadline:
            raise AssertionError(f"server processed {server.store.processed}"
                                 f" of {n} lines")
        time.sleep(0.02)


def _merged(server) -> int:
    """Records the server's lane fleets merged into its store, ever."""
    return sum(sum(f.merged_records.values()) for f in server.ingest_fleets)


def _wait_settled(server, timeout: float = 60.0) -> None:
    """Until the lanes merged nothing new for 0.25 s (a capture slows
    the process: the kernel may drop datagrams, so no exact count)."""
    deadline = time.time() + timeout
    last, since = _merged(server), time.time()
    while time.time() - since < 0.25:
        if time.time() > deadline:
            raise AssertionError("the lanes never settled")
        time.sleep(0.02)
        now = _merged(server)
        if now != last:
            last, since = now, time.time()


def _wait_own_span(server, timeout: float = 60.0) -> None:
    """Until the last flush's span re-entered the store through the span
    workers (its veneur.flush.* timers interned)."""
    deadline = time.time() + timeout
    while "veneur.flush.total_duration_ns" not in \
            server.store.histograms.interner.names:
        if time.time() > deadline:
            raise AssertionError("the flush span never reached the store")
        time.sleep(0.02)


def _http_get(port: int, path: str, timeout: float = 120.0):
    """(status, body) of a GET on 127.0.0.1; an HTTP error's status."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _demangled(mangled: str) -> str:
    """The profiler's (demangled) spelling of a kernel instance the CUDA
    runtime names mangled: warp_rows_kernel<128, false, true>."""
    hit = re.search(r"(warp|narrow|block)_rows_kernelI(?:Li(\d+)E)?"
                    r"Lb(\d)ELb(\d)E", mangled)
    if hit is None:
        raise AssertionError(f"not a t-digest kernel: {mangled!r}")
    flags = ", ".join("true" if f == "1" else "false"
                      for f in hit.group(3, 4))
    half = f"{hit.group(2)}, " if hit.group(2) else ""
    return f"{hit.group(1)}_rows_kernel<{half}{flags}>"


SCOPES = ("veneur.flush.digest.dense", "veneur.drain.digest.dense")


def _attribute_kernels(trace_path: str, names: dict) -> dict:
    """Each K1/K2 device kernel of a Chrome trace of torch.profiler,
    attributed to the veneur scope range that launched it: its launch
    call (same correlation id) inside a ``user_annotation`` of that name
    on the launching thread, or the kernel inside a
    ``gpu_user_annotation`` of it on the kernel's stream. ``names`` maps
    K1/K2 to the profiler's kernel name. Raises when the trace holds no
    device kernel at all, or a K1/K2 kernel falls in no scope."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("the capture holds no device events")
    launches = {(e.get("args") or {}).get("correlation"): e
                for e in events if e.get("cat") == "cuda_runtime"}
    cpu = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") in SCOPES]
    gpu = [e for e in events if e.get("cat") == "gpu_user_annotation"
           and e.get("name") in SCOPES]

    def inside(e, ranges, same):
        return [r["name"] for r in ranges
                if r.get(same) == e.get(same)
                and r["ts"] <= e["ts"] <= r["ts"] + r.get("dur", 0)]

    out = {}
    for label, name in names.items():
        mine = [e for e in kernels if name in e.get("name", "")]
        scopes = {}
        for e in mine:
            rt = launches.get((e.get("args") or {}).get("correlation"))
            hit = (inside(rt, cpu, "tid") if rt is not None else []) \
                or inside(e, gpu, "tid")
            if not hit:
                raise AssertionError(f"{label} kernel at ts {e['ts']} lies "
                                     f"in no veneur scope")
            scopes[hit[0]] = scopes.get(hit[0], 0) + 1
        out[label] = {"kernel": name, "device_kernels": len(mine),
                      "by_scope": scopes}
    out["device_events"] = len(kernels)
    return out


def _capture_over(port: int, seconds: float, work) -> dict:
    """GET /debug/xprof?seconds=N on a thread while ``work()`` runs again
    and again until the capture returns; the route's JSON body."""
    box = {}
    th = threading.Thread(target=lambda: box.update(
        r=_http_get(port, f"/debug/xprof?seconds={seconds}")))
    th.start()
    cycles = 0
    while th.is_alive():
        work()
        cycles += 1
    th.join()
    status, body = box["r"]
    if status != 200:
        raise AssertionError(f"/debug/xprof answered {status}: {body}")
    data = json.loads(body)
    data["work_cycles"] = cycles
    return data


def _server_rows(rows):
    """A flush's rows of the traffic (srv.*) by (name, tags)."""
    return {(m.name, tuple(m.tags)): m.value for m in rows
            if m.name.startswith("srv.")}


def phase_server(dev, series: int = 300, lines_per_series: int = 12):
    """The UDP server end to end with a channel sink, and the obs plane
    on it: the flush timeline, /debug/vars, the self-metrics of the next
    flush, a /debug/xprof capture that attributes K1 and K2 to their
    flush and drain scopes, and a twin Server with obs_enabled false."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    rng = np.random.default_rng(SEED + 1)
    lines, counters, hists, members = _server_lines(rng, series,
                                                    lines_per_series)
    kinds = ("c", "g", "h", "ms", "s")

    def server_of(obs: bool):
        sink = ChannelMetricSink()
        cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                     interval="3600s", percentiles=[0.5, 0.99],
                     aggregates=["min", "max", "count"], hostname="smoke",
                     http_address="127.0.0.1:0", obs_enabled=obs)
        return Server(cfg, metric_sinks=[sink], device=dev), sink

    server, sink = server_of(True)
    _reset_counts(tc)
    server.start()
    obs = {}
    try:
        port, http = server.statsd_addrs[0][1], server.ops_server.port
        _send_lines(port, lines)
        _wait_processed(server, len(lines))
        server.flush()
        k1_name = _demangled(tc.last_kernel_name())
        rows = sink.get_flush(timeout=60)
        k1 = tc.drain_quantile.launches
        # the flush timeline: an entry an interval, the store's stages
        status, body = _http_get(http, "/debug/flush-timeline")
        tl = json.loads(body)
        if status != 200 or tl["published_total"] != 1:
            raise AssertionError(f"/debug/flush-timeline: {status} {body}")
        entry = tl["intervals"][-1]
        names = {st["name"] for st in entry["stages"]}
        want = {"store", "store.swap", "store.dispatch",
                "store.dispatch.histograms.compute",
                "store.histograms.fetch"}
        if not want <= names:
            raise AssertionError(f"stages {sorted(want - names)} missing")
        store_node = next(n for n in entry["tree"] if n["name"] == "store")
        obs["coverage_ratio"] = entry["coverage_ratio"]
        obs["stages_ms"] = {st["name"]: st["duration_ns"] / 1e6
                            for st in entry["stages"]
                            if st["name"].count(".") < 2}
        obs["store_children"] = [c["name"] for c in store_node["children"]]
        # /debug/vars: the kernel scopes' dispatches, the CUDA launches
        status, body = _http_get(http, "/debug/vars")
        kern = json.loads(body)["obs"]["kernels"]
        for scope in ("flush.digest.dense", "drain.digest.dense"):
            if not kern["dispatches"].get(scope):
                raise AssertionError(f"/debug/vars counts no {scope}")
        if kern["launches"]["drain_quantile"]["launches"] != k1:
            raise AssertionError(f"/debug/vars launches {kern['launches']}")
        obs["vars_dispatches"] = kern["dispatches"]
        obs["vars_launches"] = kern["launches"]
        # the next flush carries the first one's self-metrics
        _wait_own_span(server)
        server.flush()
        own = [m for m in sink.get_flush(timeout=60)
               if m.name.startswith("veneur.")]
        stage_tags = {t for m in own
                      if m.name == "veneur.obs.stage_duration_ns.99percentile"
                      for t in m.tags}
        if not ({"stage:store", "stage:post"} <= stage_tags and any(
                m.name.startswith("veneur.flush.total_duration_ns.")
                for m in own)):
            raise AssertionError(f"the self-metrics are missing: "
                                 f"{sorted({m.name for m in own})[:40]}")
        obs["self_metric_rows"] = len(own)
        obs["stage_tags"] = len(stage_tags)
        # a capture over flushes whose ingest trips the shift guard (K2
        # under drain.digest.dense) before the flush (K1 under
        # flush.digest.dense)
        with _uncounted(tc):
            ka = _k2_inputs(dev)
            tc.compress_presorted(*ka, COMPRESSION, ka[0].shape[-1])
            k2_name = _demangled(tc.last_kernel_name())
        shifted = []
        for ln in lines:
            name, rest = ln.split(":", 1)
            value, tail = rest.split("|", 1)
            if tail.startswith(("h", "ms")):
                rest = f"{float(value) + 1000.0!r}|{tail}"
            shifted.append(f"{name}:{rest}")

        def cycle():
            # a snapshot (a checkpoint's) drains the first half into the
            # bins; the flush's drain of the shifted half then trips the
            # shift guard: K2, then K1
            _send_lines(port, lines)
            _wait_settled(server)
            server.store.snapshot_state()
            _send_lines(port, shifted)
            _wait_settled(server)
            server.flush()
            sink.get_flush(timeout=60)

        cap = _capture_over(http, 3, cycle)
        obs["xprof"] = {k: cap[k] for k in ("seconds", "work_cycles",
                                            "files")}
        obs["xprof"].update(_attribute_kernels(
            cap["files"][0]["path"], {"K1": k1_name, "K2": k2_name}))
        for label, scope in (("K1", SCOPES[0]), ("K2", SCOPES[1])):
            got = obs["xprof"][label]
            if not got["device_kernels"] or scope not in got["by_scope"]:
                raise AssertionError(f"the capture attributes no {label} "
                                     f"kernel to {scope}: {got}")
    finally:
        server.shutdown()
    if k1 < 1:
        raise AssertionError("the server flush did not launch K1")
    by = {}
    for m in rows:
        by.setdefault(m.name, []).append(m)
    types = {}
    for m in rows:
        kind = m.name.split(".")[1]
        types[kind] = types.get(kind, 0) + 1
    per_kind = series // len(kinds)
    want = {"c": per_kind, "g": per_kind, "s": per_kind,
            "h": per_kind * 5, "ms": per_kind * 5}
    if types != want:
        raise AssertionError(f"rows per type {types}, want {want}")
    for name, total in counters.items():
        if [m.value for m in by[name]] != [float(total)]:
            raise AssertionError(f"{name}: counter {by[name]} != {total}")
    for name, vals in hists.items():
        lo, hi = min(vals), max(vals)
        for suffix in ("50percentile", "99percentile"):
            v = by[f"{name}.{suffix}"][0].value
            if not lo <= v <= hi:
                raise AssertionError(f"{name}.{suffix} {v} outside "
                                     f"[{lo}, {hi}]")
        if by[f"{name}.count"][0].value != len(vals):
            raise AssertionError(f"{name}.count wrong")
    for name, ms in members.items():
        if abs(by[name][0].value - len(ms)) > 0.02 * len(ms) + 0.5:
            raise AssertionError(f"{name}: estimate {by[name][0].value} vs "
                                 f"{len(ms)} members")
    # the twin with the plane off: the same rows but veneur.*, no timeline
    twin, tsink = server_of(False)
    with _uncounted(tc):
        twin.start()
        try:
            _send_lines(twin.statsd_addrs[0][1], lines)
            _wait_processed(twin, len(lines))
            twin.flush()
            twin_rows = tsink.get_flush(timeout=60)
            timeline_status, _ = _http_get(twin.ops_server.port,
                                           "/debug/flush-timeline")
        finally:
            twin.shutdown()
    got, want_rows = _server_rows(rows), _server_rows(twin_rows)
    if set(got) != set(want_rows) or any(
            got[k] != want_rows[k] for k in got
            if "percentile" not in k[0] and not k[0].startswith("srv.s.")):
        raise AssertionError("the obs_enabled: false twin flushed other "
                             "rows")
    if timeline_status != 404 or any(m.name.startswith("veneur.")
                                     for m in twin_rows):
        raise AssertionError(f"the twin with obs off answered "
                             f"{timeline_status} / emitted veneur.* rows")
    emit({"phase": "server", "lines": len(lines), "rows_flushed": len(rows),
          "rows_per_type": types, "twin_rows_equal": True,
          "launches": _counts(tc), "obs": obs,
          "packet_errors": server.packet_errors})


def _k2_inputs(dev, rows: int = 64):
    """K2's inputs at the store's width (K = 104 at compression 100):
    two row-ascending centroid halves of ``rows`` rows, weight 1."""
    import torch

    from veneur_tpu_torch.ops import tdigest as td

    k = td.size_bound(COMPRESSION)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ma = torch.sort(torch.rand(rows, k, generator=gen), dim=-1)[0]
    mb = torch.sort(torch.rand(rows, k, generator=gen), dim=-1)[0]
    w = torch.ones(rows, k)
    return (ma.to(dev), w.to(dev), mb.to(dev), w.clone().to(dev))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _global_merge_traffic(rows: int, set_series: int, gcounters: int):
    """The global_merge phase's data, from the seed: local A's and B's
    histogram samples (4 a series; B's shifted by +1000), set members
    (every set in both locals, each holding ~60% of the set's universe)
    and global-only counters."""
    # one generator per array, so a smaller call draws exactly the first
    # rows, sets and counters of a larger one
    rng = iter([np.random.default_rng(s) for s in
                np.random.SeedSequence(SEED + 2).spawn(8)])
    t = {"a": next(rng).gamma(2.0, 10.0, (rows, 4)).astype(np.float32),
         "b": (1000.0 + next(rng).gamma(2.0, 10.0, (rows, 4))
               ).astype(np.float32)}
    t["card"] = next(rng).integers(100, 1001, set_series)
    t["universe"] = next(rng).integers(0, np.iinfo(np.uint64).max,
                                       int(t["card"].sum()),
                                       dtype=np.uint64, endpoint=True)
    t["owner"] = np.repeat(np.arange(set_series, dtype=np.int32), t["card"])
    for label in ("a", "b"):
        t[f"{label}_keep"] = next(rng).random(len(t["universe"])) < 0.6
        t[f"{label}_ctr"] = next(rng).integers(1, 1000, gcounters)
    return t


def _forwarding_local(dev, chunk, vals, set_owner, set_hashes, set_series,
                      ctrs, aggs):
    """One port local on ``dev``: a histogram series per row of ``vals``
    (weight 2), the sets, the global-only counters, then one forwarding
    flush. Returns (ForwardableState with its per-row digest lists
    built, the flush's time split)."""
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric

    rows = len(vals)
    store = MetricStore(initial_capacity=1024, chunk=chunk, device=dev)
    hist, sets = store.histograms, store.sets
    for i in range(rows):
        hist.interner.intern(MetricKey(f"h.{i}", "histogram", ""), [])
    hist.ensure_capacity(rows - 1)
    for i in range(set_series):
        sets.interner.intern(MetricKey(f"s.{i}", "set", ""), [])
    sets.ensure_capacity(set_series - 1)
    with store._lock:
        hist.sample_many(np.repeat(np.arange(rows, dtype=np.int32), 4),
                         vals.reshape(-1),
                         np.full(vals.size, 2.0, np.float32))
        sets.sample_many(set_owner, set_hashes)
    for i, v in enumerate(ctrs):
        store.process_metric(parse_metric(
            f"g.c.{i}:{int(v)}|c|#veneurglobalonly".encode()))
    _sync(dev)

    # where the forwarding flush's time goes, timed around the store's
    # own methods: dispatch (host enqueue), collect (every device->host
    # fetch), the digest-plane part of the fetch, the per-row emission;
    # then the forward-list build (ForwardableState.materialize_digests)
    split = {"dispatch_s": 0.0, "collect_s": 0.0, "digest_fetch_s": 0.0,
             "emit_s": 0.0}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[name] += time.perf_counter() - t
        return run

    hist._flush_dispatch = timed("dispatch_s", hist._flush_dispatch)
    hist._flush_collect = timed("collect_s", hist._flush_collect)
    hist._fetch_planes = timed("digest_fetch_s", hist._fetch_planes)
    store._emit_digest_result = timed("emit_s", store._emit_digest_result)
    t0 = time.perf_counter()
    flushed, fwd = store.flush(list(PERCENTILES), aggs, 0, is_local=True)
    split["flush_s"] = time.perf_counter() - t0
    final = flushed.to_intermetrics()
    t0 = time.perf_counter()
    fwd.materialize_digests()
    split["forward_list_s"] = time.perf_counter() - t0
    if len(final) != 3 * rows or len(fwd.histograms) != rows \
            or len(fwd.sets) != set_series or len(fwd.counters) != len(ctrs):
        raise AssertionError(
            f"local flushed {len(final)} rows and forwarded "
            f"{len(fwd.histograms)} digests, {len(fwd.sets)} sets, "
            f"{len(fwd.counters)} counters")
    return fwd, split


def _events_ms(dev, fn):
    """(result, device ms between CUDA events recorded before and after
    ``fn`` on the current stream), or (result, None) off the card."""
    import torch

    if dev.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_global_merge(dev, rows: int, set_series: int, gcounters: int,
                     chunk: int):
    """Two port locals A and B forward to a port global, all on ``dev``:
    the locals flush as forwarding locals; the global imports both
    ForwardableStates (digests through import_digests_bulk, sets and
    counters through the JSON body and apply_json_metric_list) and
    flushes. Checks conservation, extrema, percentiles, counters and
    set estimates. Returns (record, the global's merged digests and
    percentiles as host tensors)."""
    from veneur_tpu_torch.core import store as store_mod
    from veneur_tpu_torch.core.store import ForwardableState, MetricStore
    from veneur_tpu_torch.forward.convert import (apply_json_metric_list,
                                                  json_metrics_from_state)
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates
    from veneur_tpu_torch.samplers.parser import MetricKey

    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    t = _global_merge_traffic(rows, set_series, gcounters)
    rec = {"histogram_series": rows, "set_series": set_series,
           "global_counters": gcounters, "chunk": chunk}
    states = []
    for label in ("a", "b"):
        keep = t[f"{label}_keep"]
        fwd, split = _forwarding_local(
            dev, chunk, t[label], t["owner"][keep], t["universe"][keep],
            set_series, t[f"{label}_ctr"], aggs)
        rec[f"local_{label}"] = split
        states.append(fwd)

    # digests go through import_digests_bulk, the store call that
    # apply_json_metric_list makes once a body is parsed; the JSON text
    # of 1M digests is host Python only (server_global times that path)
    glob = MetricStore(initial_capacity=1024, chunk=chunk, device=dev)
    gh = glob.histograms
    counts = {"import_drains": 0, "stat_only_drains": 0, "guard_drains": 0}
    real_drain_imports, real_drain_temp = gh._drain_imports, td.drain_temp

    def drain_imports():
        if gh._imp_fill:
            counts["import_drains"] += 1
        elif gh._imp_stat_fill:
            counts["stat_only_drains"] += 1
        real_drain_imports()

    def drain_temp(*args, **kwargs):
        counts["guard_drains"] += 1
        return real_drain_temp(*args, **kwargs)

    gh._drain_imports, td.drain_temp = drain_imports, drain_temp
    split = {"digests_s": 0.0, "json_s": 0.0}
    try:
        t0 = time.perf_counter()
        for fwd in states:
            t1 = time.perf_counter()
            glob.import_digests_bulk([
                (MetricKey(name, "histogram", ",".join(tags)), tags, means,
                 weights, lo, hi)
                for name, tags, means, weights, lo, hi in fwd.histograms])
            t2 = time.perf_counter()
            rest = ForwardableState(counters=fwd.counters, sets=fwd.sets)
            body = json.loads(json.dumps(json_metrics_from_state(rest)))
            n_ok, n_err = apply_json_metric_list(glob, body)
            if n_err or n_ok != set_series + gcounters:
                raise AssertionError(f"JSON import: {n_ok} ok, {n_err} "
                                     "errors")
            split["digests_s"] += t2 - t1
            split["json_s"] += time.perf_counter() - t2
        with glob._lock:
            gh._drain_staging()
            glob.sets._drain_staging()
        _sync(dev)
        rec["import_s"] = time.perf_counter() - t0
    finally:
        td.drain_temp = real_drain_temp
    rec["import_split"] = split
    rec.update(counts)
    rec["imported"] = glob.imported

    # the global flush; its merged digests are captured from the flush
    # program (the histograms group is the first non-empty digest group)
    captured = []
    real_flush = store_mod._flush_digests

    def capture(*args):
        out = real_flush(*args)
        captured.append(out[:2])
        return out

    def dispatch_timed(*args, _real=gh._flush_dispatch):
        # the flush program's device time: CUDA events around the
        # dispatch (the temp half's sort, K1, the stat slices)
        out, ms = _events_ms(dev, lambda: _real(*args))
        rec["global_flush_program_device_ms"] = ms
        return out

    real_launch = tc.launch_drain_quantile

    def k1_timed(*args, **kwargs):
        # K1 alone: events around its one launch (counted by the wrapper)
        out, ms = _events_ms(dev, lambda: real_launch(*args, **kwargs))
        rec["global_flush_k1_device_ms"] = ms
        return out

    gh._flush_dispatch = dispatch_timed
    store_mod._flush_digests = capture
    tc.launch_drain_quantile = k1_timed
    try:
        t0 = time.perf_counter()
        flushed, _ = glob.flush(list(PERCENTILES), aggs, 0)
        rec["global_flush_s"] = time.perf_counter() - t0
    finally:
        store_mod._flush_digests = real_flush
        tc.launch_drain_quantile = real_launch
    digest, pcts = captured[0]
    merged = [x[:rows].cpu() for x in (digest.mean, digest.weight,
                                       digest.min, digest.max)]
    merged.append(pcts[:rows, :-1].cpu())
    final = flushed.to_intermetrics()
    _check_global_merge(t, states, merged, final, rows, set_series,
                        gcounters, rec)
    return rec, merged


def _check_global_merge(t, states, merged, final, rows, set_series,
                        gcounters, rec):
    """The global against the raw data: each row's merged weight equals
    A's plus B's forwarded weight and the sample mass (16) at rtol 1e-6;
    min/max exact; percentiles within 1e-3 x span of the exact digest of
    the union of both locals' samples (8 centroids of weight 2 a row);
    counters exact; set estimates within the HLL error of the true union
    cardinality and within 1e-4 of a numpy HLL of the union."""
    _, weight, mn, mx, _ = (x.numpy() for x in merged)
    fwd_w = [np.array([e[3].sum() for e in fwd.histograms])
             for fwd in states]
    mass = weight.astype(np.float64).sum(1)
    for want in (fwd_w[0] + fwd_w[1], np.full(rows, 16.0)):
        err = float(np.max(np.abs(mass - want) / want))
        if err > 1e-6:
            raise AssertionError(f"merged weight off by {err:.3g}")
    raw = np.concatenate([t["a"], t["b"]], axis=1)
    if not (np.array_equal(mn, raw.min(1)) and np.array_equal(mx, raw.max(1))):
        raise AssertionError("merged min/max differ from the raw samples")
    npct = len(PERCENTILES)
    rng = np.random.default_rng(SEED + 3)
    worst = rank_worst = 0.0
    for i in rng.choice(rows, min(512, rows), replace=False):
        ms = final[i * npct:(i + 1) * npct]
        if [m.name for m in ms] != [f"h.{i}.{int(p * 100)}percentile"
                                    for p in PERCENTILES]:
            raise AssertionError(f"unexpected emission order at h.{i}")
        got = np.array([m.value for m in ms])
        want = _digest_reference(raw[i], PERCENTILES)
        span = float(raw[i].max() - raw[i].min())
        worst = max(worst, float(np.max(np.abs(got - want))) / span)
        srt = np.sort(raw[i].astype(np.float64))
        ranks = np.interp(got, srt, np.linspace(0.0, 1.0, len(srt)))
        rank_worst = max(rank_worst, float(np.max(np.abs(
            ranks - np.array(PERCENTILES)))))
    if worst > 1e-3:
        raise AssertionError(f"global percentiles off the union's exact "
                             f"digest by {worst:.3g} of the span")
    tail = {m.name: m.value for m in final[rows * npct:]}
    if len(final) != rows * npct + set_series + gcounters:
        raise AssertionError(f"global flushed {len(final)} rows")
    for i in range(gcounters):
        want = int(t["a_ctr"][i]) + int(t["b_ctr"][i])
        if tail[f"g.c.{i}"] != want:
            raise AssertionError(f"g.c.{i}: {tail[f'g.c.{i}']} != {want}")
    union = t["a_keep"] | t["b_keep"]
    card = np.bincount(t["owner"][union], minlength=set_series)
    est = np.array([tail[f"s.{i}"] for i in range(set_series)])
    rel = np.abs(est - card) / card
    starts = np.concatenate([[0], np.cumsum(t["card"])])
    ref_err = 0.0
    for i in rng.choice(set_series, min(256, set_series), replace=False):
        lo, hi = starts[i], starts[i + 1]
        ref = _hll_reference(t["universe"][lo:hi][union[lo:hi]], 14)
        ref_err = max(ref_err, abs(est[i] - ref) / ref)
    if ref_err > 1e-4:
        raise AssertionError(f"set estimates off the numpy HLL of the "
                             f"union by {ref_err:.3g}")
    if np.percentile(rel, 99) > 0.02 or rel.max() > 0.05:
        raise AssertionError(f"set estimates too far from the union "
                             f"cardinality: p99 {np.percentile(rel, 99):.3g}"
                             f", max {rel.max():.3g}")
    rec.update({"pct_err_vs_exact_union_digest": worst,
                "rank_err_vs_np_quantile_max": rank_worst,
                "set_err_vs_numpy_hll": ref_err,
                "set_rel_err_p50": float(np.median(rel)),
                "set_rel_err_p99": float(np.percentile(rel, 99))})


def phase_global_merge(dev, card: str, rows: int = GLOBAL_MERGE_ROWS,
                       set_series: int = SET_SERIES, gcounters: int = 4096,
                       chunk: int = 1 << 14, twin_rows: int = 4096):
    """Global aggregation over the JSON body on the card
    (run_global_merge at GLOBAL_MERGE_ROWS histogram series a local;
    native_merge runs the full width), then a 4,096-row slice of the same
    traffic through the same path on the card and on the CPU (the plain
    versions): the twins' merged digests must agree as the kernels do.
    Returns the launch counts of its main run."""
    import torch

    from veneur_tpu_torch.ops import tdigest_cuda as tc

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(tc)
    t0 = time.perf_counter()
    rec, _ = run_global_merge(dev, rows, set_series, gcounters, chunk)
    rec["phase_s"] = time.perf_counter() - t0
    counts = _counts(tc)
    rec["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(dev))
    k1, k2 = counts["drain_quantile.launches"], \
        counts["compress_presorted.launches"]
    if k1 < 3 or k2 < 1 or k2 != rec["guard_drains"]:
        raise AssertionError(f"global_merge launched K1 {k1}x, K2 {k2}x "
                             f"({rec['guard_drains']} guard drains); want "
                             "K1 >= 3 (two locals, the global) and one K2 "
                             "per guard drain, at least one")
    rec["launches"] = counts
    card_run = run_global_merge(dev, twin_rows, 64, 64, chunk)[1]
    cpu_run = run_global_merge(torch.device("cpu"), twin_rows, 64, 64,
                               chunk)[1]
    gm, gw, gmin, gmax, gp = card_run
    pm, pw, pmin, pmax, pp = cpu_run
    if not (torch.equal(gmin, pmin) and torch.equal(gmax, pmax)):
        raise AssertionError("twin extrema differ")
    rec["cpu_twin_rows"] = twin_rows
    rec["cpu_twin_max_abs_err"] = _compare(
        "global_merge cpu twin", (gm, gw, gp), (pm, pw, pp), pw,
        torch.zeros_like(pw), (pmax - pmin).float())
    emit({"phase": "global_merge", "card": card, **rec})
    _RECORDS["global_merge"] = rec
    return counts


# the native_merge phase: the packed binary forward at full width


def _packed_row_weights(planes) -> np.ndarray:
    """Each row's forwarded mass (float64) from PackedDigestPlanes."""
    counts = planes.counts.astype(np.int64)
    return np.bincount(np.repeat(np.arange(len(counts)), counts),
                       weights=planes.weights_f32().astype(np.float64),
                       minlength=len(counts))


def _native_local(dev, chunk, vals, set_owner, set_hashes, set_series,
                  ctrs, aggs, fwd):
    """One port local on ``dev``, fed as ``_forwarding_local`` feeds it,
    flushed as a forwarding local in the default columnar shape with
    ``digest_format="packed"``; ``fwd`` (a NativeForwarder) sends its
    state over loopback TCP. Returns (record, the histogram group's
    PackedDigestPlanes)."""
    import torch

    from veneur_tpu_torch.core import slab as slab_mod
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric

    rows = len(vals)
    store = MetricStore(initial_capacity=1024, chunk=chunk, device=dev)
    hist, sets = store.histograms, store.sets
    for i in range(rows):
        hist.interner.intern(MetricKey(f"h.{i}", "histogram", ""), [])
    hist.ensure_capacity(rows - 1)
    for i in range(set_series):
        sets.interner.intern(MetricKey(f"s.{i}", "set", ""), [])
    sets.ensure_capacity(set_series - 1)
    with store._lock:
        hist.sample_many(np.repeat(np.arange(rows, dtype=np.int32), 4),
                         vals.reshape(-1),
                         np.full(vals.size, 2.0, np.float32))
        sets.sample_many(set_owner, set_hashes)
    for i, v in enumerate(ctrs):
        store.process_metric(parse_metric(
            f"g.c.{i}:{int(v)}|c|#veneurglobalonly".encode()))
    _sync(dev)

    rec = {"dispatch_s": 0.0, "pack_s": 0.0, "fetch_s": 0.0,
           "fetched_bytes": 0}
    twin = {}
    real_pack = slab_mod._pack_slab
    real_slice, real_gather = slab_mod._slice_pack, slab_mod._gather_pack

    def pack(mean, weight, dmin, dmax):
        # the pack alone on the device: synchronized before and after
        _sync(dev)
        t = time.perf_counter()
        out = real_pack(mean, weight, dmin, dmax)
        _sync(dev)
        rec["pack_s"] += time.perf_counter() - t
        if not twin:
            n = NATIVE_TWIN_ROWS
            twin["in"] = [x[:n].cpu() for x in (mean, weight, dmin, dmax)]
            twin["out"] = [x[:n].cpu() for x in out]
        return out

    def fetched(fn):
        def run(*args):
            out = fn(*args)
            parts = out if isinstance(out, tuple) else (out,)
            rec["fetched_bytes"] += sum(p.numel() * p.element_size()
                                        for p in parts)
            return out
        return run

    def timed(key, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec[key] += time.perf_counter() - t
        return run

    slab_mod._pack_slab = pack
    slab_mod._slice_pack = fetched(real_slice)
    slab_mod._gather_pack = fetched(real_gather)
    hist._flush_dispatch = timed("dispatch_s", hist._flush_dispatch)
    hist._fetch_planes = timed("fetch_s", hist._fetch_planes)
    try:
        t0 = time.perf_counter()
        flushed, state = store.flush(list(PERCENTILES), aggs, 0,
                                     is_local=True, columnar=True,
                                     digest_format="packed")
        rec["flush_s"] = time.perf_counter() - t0
    finally:
        slab_mod._pack_slab = real_pack
        slab_mod._slice_pack, slab_mod._gather_pack = real_slice, \
            real_gather
    # the dispatch's own host time: the pack (and the wait for K1 before
    # it) are timed apart
    rec["dispatch_s"] -= rec["pack_s"]
    planes = state.histograms_columnar[2]
    if planes.nrows != rows or len(state.sets) != set_series \
            or len(state.counters) != len(ctrs) or len(flushed) != 3 * rows:
        raise AssertionError(f"local flushed {len(flushed)} rows, packed "
                             f"{planes.nrows} digests, {len(state.sets)} "
                             f"sets, {len(state.counters)} counters")
    # counts (int32) and the extrema cross with the live bytes
    rec["fetched_bytes"] += rows * (4 + 4 + 4)
    rec["dense_fetch_bytes"] = rows * (2 * hist.k * 4 + 2 * 4)
    rec["live_centroids"] = int(planes.counts.astype(np.int64).sum())
    rec["packed_bytes"] = planes.nbytes
    # the pack on the card against its CPU run on the same planes
    cpu_out = real_pack(*twin["in"])
    for got, want in zip(twin["out"], cpu_out):
        if not torch.equal(got, want):
            raise AssertionError("the pack on the card differs from the "
                                 "CPU's")
    rec["pack_twin_rows"] = NATIVE_TWIN_ROWS
    frames0, bytes0 = len(fwd.post_content_lengths), \
        sum(fwd.post_content_lengths)
    weights = _packed_row_weights(planes)
    # the mesh phase forwards this same state into a mesh global (the
    # forward consumes the digest planes of the one it sends)
    rec["state"] = copy.copy(state)
    if fwd.forward(state) is not True:
        raise AssertionError(f"native forward failed ({fwd.errors} errors, "
                             f"{fwd.retries} retries)")
    rec.update(encode_s=fwd.encode_durations[-1],
               send_s=fwd.post_durations[-1],
               frames=len(fwd.post_content_lengths) - frames0,
               wire_bytes=sum(fwd.post_content_lengths) - bytes0)
    return rec, weights


class _ImportProbe:
    """Times a port global store's columnar import, the same way for the
    native:// and the gRPC import server: the C++ decode, the miss loop
    (``_intern_mlist``), ``import_columnar``, the import drains (device-
    synchronized) and the server's handler (``handler``, its method
    that runs one request or frame); counts the import drains and the
    guard drains (each a K2 launch). A context manager: the module
    functions it wraps are restored on exit."""

    def __init__(self, dev, glob, srv, handler: str):
        self.dev, self.glob = dev, glob
        self.split = {"decode_s": 0.0, "miss_loop_s": 0.0,
                      "import_columnar_s": 0.0, "drains_s": 0.0,
                      "merge_s": 0.0}
        self.counts = {"import_drains": 0, "guard_drains": 0}
        gh = glob.histograms
        real_drain_imports = gh._drain_imports

        def drain_imports():
            if gh._imp_fill:
                self.counts["import_drains"] += 1
            real_drain_imports()

        gh._drain_imports = self._timed("drains_s", drain_imports,
                                        sync=True)
        glob._intern_mlist = self._timed("miss_loop_s", glob._intern_mlist)
        glob.import_columnar = self._timed("import_columnar_s",
                                           glob.import_columnar)
        setattr(srv, handler, self._timed("merge_s", getattr(srv, handler)))

    def _timed(self, key, fn, sync=False):
        def run(*args, **kwargs):
            if sync:
                _sync(self.dev)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    _sync(self.dev)
                self.split[key] += time.perf_counter() - t0
        return run

    def __enter__(self):
        from veneur_tpu_torch.native import egress
        from veneur_tpu_torch.ops import tdigest as td

        self._real = (egress.decode_metric_list, td.drain_temp)

        def drain_temp(*args, **kwargs):
            self.counts["guard_drains"] += 1
            return self._real[1](*args, **kwargs)

        egress.decode_metric_list = self._timed("decode_s", self._real[0])
        td.drain_temp = drain_temp
        return self

    def __exit__(self, *exc):
        from veneur_tpu_torch.native import egress
        from veneur_tpu_torch.ops import tdigest as td

        egress.decode_metric_list, td.drain_temp = self._real

    def final_drain(self):
        """Drain what the imports left staged, timed whole (inside the
        probe's context, so its guard drains count)."""
        glob = self.glob
        t0 = time.perf_counter()
        with glob._lock:
            glob.histograms._drain_staging()
            glob.sets._drain_staging()
        _sync(self.dev)
        self.split["final_drain_s"] = time.perf_counter() - t0

    def record(self, rec: dict) -> None:
        """The import, split: decode (C++), the row assignment with its
        miss loop, the numpy staging and the device drains it runs (K2
        on the guard)."""
        split = self.split
        split["staging_s"] = (split["import_columnar_s"]
                              - split["miss_loop_s"] - split["drains_s"])
        split["drains_s"] += split["final_drain_s"]
        rec["import_s"] = split["merge_s"] + split["final_drain_s"]
        rec["import_split"] = split
        rec.update(self.counts)
        rec["imported"] = self.glob.imported


def _flush_global(dev, glob, aggs, rows: int, rec: dict):
    """A global store's columnar flush (K1, its device time by CUDA
    events); returns (the ColumnarFlush, [weight, min, max] of the first
    ``rows`` digest rows, their percentiles)."""
    from veneur_tpu_torch.core import store as store_mod
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    captured = []
    real_flush = store_mod._flush_digests

    def capture(*args):
        out = real_flush(*args)
        captured.append(out[:2])
        return out

    real_launch = tc.launch_drain_quantile

    def k1_timed(*args, **kwargs):
        out, ms = _events_ms(dev, lambda: real_launch(*args, **kwargs))
        rec.setdefault("global_flush_k1_device_ms", ms)
        return out

    store_mod._flush_digests = capture
    tc.launch_drain_quantile = k1_timed
    try:
        t0 = time.perf_counter()
        flushed, _ = glob.flush(list(PERCENTILES), aggs, 0, columnar=True)
        rec["global_flush_s"] = time.perf_counter() - t0
    finally:
        store_mod._flush_digests = real_flush
        tc.launch_drain_quantile = real_launch
    digest, pcts = captured[0]
    merged = [x[:rows].cpu().numpy() for x in (digest.weight, digest.min,
                                                digest.max)]
    return flushed, merged, pcts[:rows, :-1].cpu().numpy()


def run_native_merge(dev, rows: int, set_series: int, gcounters: int,
                     chunk: int):
    """Two port locals A and B (the global_merge traffic) flush with
    digest_format="packed" and send through real NativeForwarders over
    loopback TCP into a real NativeImportServer on a port global, which
    decodes the frames in C++, assigns rows through the C++ MetricList
    table, bulk-stages them (import_columnar; K2 on the import drains)
    and flushes in the default columnar shape (K1). Checks
    conservation, extrema, percentiles, counters and set estimates.
    Keeps the frames each local sent for the grpc_proxy phase. Returns
    the record."""
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.forward import native_transport as tnt
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    t = _global_merge_traffic(rows, set_series, gcounters)
    rec = {"histogram_series": rows, "set_series": set_series,
           "global_counters": gcounters, "chunk": chunk}
    glob = MetricStore(initial_capacity=1024, chunk=chunk, device=dev)
    srv = tnt.NativeImportServer(glob)
    probe = _ImportProbe(dev, glob, srv, "_merge")
    # the frames each local's forward encoded, sent again over gRPC by
    # the grpc_proxy phase
    sent, real_encode = [], tnt.encode_forwardable_frames

    def encode(*args, **kwargs):
        frames = real_encode(*args, **kwargs)
        sent.append(list(frames))
        return frames

    srv.start("127.0.0.1:0")
    fwd_weights, states = [], []
    try:
        with probe:
            tnt.encode_forwardable_frames = encode
            for label in ("a", "b"):
                keep = t[f"{label}_keep"]
                fwd = tnt.NativeForwarder(f"native://127.0.0.1:{srv.port}",
                                          timeout=600.0)
                try:
                    local, weights = _native_local(
                        dev, chunk, t[label], t["owner"][keep],
                        t["universe"][keep], set_series, t[f"{label}_ctr"],
                        aggs, fwd)
                finally:
                    fwd.close()
                states.append(local.pop("state"))
                rec[f"local_{label}"] = local
                fwd_weights.append(weights)
            probe.final_drain()
    finally:
        tnt.encode_forwardable_frames = real_encode
        srv.stop()
    if srv.import_errors or srv.received != 2 * (rows + set_series
                                                 + gcounters):
        raise AssertionError(f"native import: {srv.received} merged, "
                             f"{srv.import_errors} errors")
    probe.record(rec)
    flushed, merged, pcts = _flush_global(dev, glob, aggs, rows, rec)
    _check_native_merge(t, fwd_weights, merged, pcts, flushed, rows,
                        set_series, gcounters, rec)
    # the mesh phase sends the same two states into a mesh global and
    # holds its flush to this dense global's; the grpc_proxy phase sends
    # the same frames over gRPC and holds its flush bit for bit
    _RECORDS["native_merge_states"] = (states, flushed, rows, set_series,
                                       gcounters)
    _RECORDS["native_merge_frames"] = dict(
        frames=sent, flushed=flushed, rows=rows, set_series=set_series,
        gcounters=gcounters, chunk=chunk, native=rec)
    return rec


def _check_native_merge(t, fwd_weights, merged, pcts, flushed, rows,
                        set_series, gcounters, rec):
    """The global against the raw data: each row's merged weight equals
    A's plus B's forwarded weight and the sample mass (16) exactly (every
    weight is an integer below 256, which bfloat16 holds); min/max
    exact; percentiles within 0.02 x span of the exact digest of the
    union of both locals' samples; counters exact; set estimates within
    the HLL error of the union cardinality and within 1e-4 of a numpy
    HLL of the union (the registers travel exactly)."""
    from veneur_tpu_torch.core.columnar import arena_strings

    weight, mn, mx = merged
    mass = weight.astype(np.float64).sum(1)
    if not (np.array_equal(mass, fwd_weights[0] + fwd_weights[1])
            and np.array_equal(mass, np.full(rows, 16.0))):
        raise AssertionError("merged weights differ from the forwarded")
    raw = np.concatenate([t["a"], t["b"]], axis=1)
    if not (np.array_equal(mn, raw.min(1)) and np.array_equal(mx, raw.max(1))):
        raise AssertionError("merged min/max differ from the raw samples")
    rng = np.random.default_rng(SEED + 13)
    worst = 0.0
    for i in rng.choice(rows, min(512, rows), replace=False):
        want = _digest_reference(raw[i], PERCENTILES)
        span = float(raw[i].max() - raw[i].min())
        worst = max(worst, float(np.max(np.abs(pcts[i] - want))) / span)
    if worst > 0.02:
        raise AssertionError(f"global percentiles off the union's exact "
                             f"digest by {worst:.3g} of the span")
    by_block = {}
    for blk in flushed.blocks:
        names = arena_strings(blk.names)
        by_block[names[0].split(".")[0]] = (names, blk)
    hnames, hblk = by_block["h"]
    if len(hnames) != rows or len(hblk) != rows * len(PERCENTILES):
        raise AssertionError(f"the histogram block holds {len(hblk)} "
                             "emissions")
    extras = {m.name: m.value for m in flushed.extras}
    for i in range(gcounters):
        want = int(t["a_ctr"][i]) + int(t["b_ctr"][i])
        if extras.get(f"g.c.{i}") != want:
            raise AssertionError(f"g.c.{i}: {extras.get(f'g.c.{i}')} != "
                                 f"{want}")
    snames, sblk = by_block["s"]
    est = np.zeros(set_series)
    est[[int(n[2:]) for n in snames]] = sblk.values[np.argsort(sblk.rows)]
    union = t["a_keep"] | t["b_keep"]
    card = np.bincount(t["owner"][union], minlength=set_series)
    rel = np.abs(est - card) / card
    starts = np.concatenate([[0], np.cumsum(t["card"])])
    ref_err = 0.0
    for i in rng.choice(set_series, min(256, set_series), replace=False):
        lo, hi = starts[i], starts[i + 1]
        ref = _hll_reference(t["universe"][lo:hi][union[lo:hi]], 14)
        ref_err = max(ref_err, abs(est[i] - ref) / ref)
    if ref_err > 1e-4 or np.percentile(rel, 99) > 0.02 or rel.max() > 0.05:
        raise AssertionError(f"set estimates: {ref_err:.3g} off the numpy "
                             f"HLL, p99 {np.percentile(rel, 99):.3g} and "
                             f"max {rel.max():.3g} off the union")
    rec.update({"pct_err_vs_exact_union_digest": worst,
                "set_err_vs_numpy_hll": ref_err,
                "set_rel_err_p99": float(np.percentile(rel, 99))})


def phase_native_merge(dev, card: str, rows: int = ROWS,
                       set_series: int = SET_SERIES, gcounters: int = 4096,
                       chunk: int = 1 << 14):
    """The packed binary forward and import at full width
    (run_native_merge at 1,048,576 histogram series a local), beside the
    global_merge JSON leg's import and flush seconds of the same run.
    Returns the launch counts."""
    import torch

    from veneur_tpu_torch.ops import tdigest_cuda as tc

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(tc)
    t0 = time.perf_counter()
    rec = run_native_merge(dev, rows, set_series, gcounters, chunk)
    rec["phase_s"] = time.perf_counter() - t0
    counts = _counts(tc)
    rec["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(dev))
    k1, k2 = counts["drain_quantile.launches"], \
        counts["compress_presorted.launches"]
    if k1 < 3 or k2 < 1 or k2 != rec["guard_drains"]:
        raise AssertionError(f"native_merge launched K1 {k1}x, K2 {k2}x "
                             f"({rec['guard_drains']} guard drains); want "
                             "K1 >= 3 (two locals, the global) and one K2 "
                             "per guard drain, at least one")
    rec["launches"] = counts
    json_leg = _RECORDS.get("global_merge", {})
    rec["json_leg"] = {k: json_leg.get(k) for k in (
        "histogram_series", "import_s", "global_flush_s")}
    emit({"phase": "native_merge", "card": card, **rec})
    return counts


PROXY_SERIES = 1 << 15           # the proxy tier's histogram series a local
#                                  (65,536 until the lifecycle phase came)
PROXY_SETS = 4096                # its sets (each in both locals)
PROXY_SCALARS = 4096             # its global-only counters and gauges


def _same_flush(got, want) -> None:
    """Two global ColumnarFlushes bit for bit: every block's names in
    order, suffixes and values (NaN where NaN), and the extras."""
    g, w = _blocks_by_prefix(got, 0), _blocks_by_prefix(want, 0)
    if set(g) != set(w):
        raise AssertionError(f"blocks {sorted(g)} vs {sorted(w)}")
    for key, (blk, names) in g.items():
        wblk, wnames = w[key]
        if names != wnames or blk.suffixes != wblk.suffixes or not \
                np.array_equal(_block_matrix(blk), _block_matrix(wblk),
                               equal_nan=True):
            raise AssertionError(f"group {key} differs from the native:// "
                                 "global's")
    gx = [(m.name, tuple(m.tags), m.value) for m in got.extras]
    wx = [(m.name, tuple(m.tags), m.value) for m in want.extras]
    if gx != wx:
        raise AssertionError("extras differ from the native:// global's")


def run_grpc_global(dev) -> dict:
    """Leg (a) of grpc_proxy: the frames native_merge's two 1M-series
    locals encoded (packed digests, sets, global-only counters) go again,
    unchanged, through GRPCForwarder.send_frames over loopback gRPC into
    an ImportServer on a fresh dense global store (the same chunk and
    capacity), which decodes them in C++ and merges them through
    import_columnar (K2 on its guard drains) and flushes columnar (K1).
    Its rows must equal the native:// global's bit for bit. Prints the
    import split, each local's send (through the last reply, and less
    the global's merge: the wire), frames and bytes. Returns the record
    and the launch counts."""
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.forward.grpc_forward import (GRPCForwarder,
                                                       ImportServer)
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    # the fleet_ha phase takes them after
    src = _RECORDS["native_merge_frames"]
    rows, set_series, gcounters = (src["rows"], src["set_series"],
                                   src["gcounters"])
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    rec = {"histogram_series": rows, "set_series": set_series,
           "global_counters": gcounters, "chunk": src["chunk"]}
    _reset_counts(tc)
    glob = MetricStore(initial_capacity=1024, chunk=src["chunk"],
                       device=dev)
    srv = ImportServer(glob)
    probe = _ImportProbe(dev, glob, srv, "_send_metrics")
    srv.start("127.0.0.1:0")
    try:
        with probe:
            for label, frames in zip("ab", src["frames"]):
                merge0 = probe.split["merge_s"]
                fwd = GRPCForwarder(f"127.0.0.1:{srv.port}", timeout=600.0)
                try:
                    if fwd.send_frames(frames) is not True:
                        raise AssertionError(f"gRPC send failed "
                                             f"({fwd.errors} errors)")
                finally:
                    fwd.close()
                # the digest frames come first; their rows are the series
                done, digest_bytes = 0, 0
                for payload, n in frames:
                    if done >= rows:
                        break
                    done += n
                    digest_bytes += len(payload)
                send_s = fwd.post_durations[-1]
                rec[f"local_{label}"] = {
                    "send_s": send_s,
                    "wire_s": send_s - (probe.split["merge_s"] - merge0),
                    "frames": len(fwd.post_content_lengths),
                    "wire_bytes": sum(fwd.post_content_lengths),
                    "digest_wire_bytes": digest_bytes,
                    "retries": fwd.retries}
            probe.final_drain()
    finally:
        srv.stop()
    if srv.import_errors or srv.received != 2 * (rows + set_series
                                                 + gcounters):
        raise AssertionError(f"gRPC import: {srv.received} merged, "
                             f"{srv.import_errors} errors")
    probe.record(rec)
    flushed, _, _ = _flush_global(dev, glob, aggs, rows, rec)
    counts = _counts(tc)
    _same_flush(flushed, src["flushed"])
    rec["rows_equal_native_global"] = True
    k1, k2 = counts["drain_quantile.launches"], \
        counts["compress_presorted.launches"]
    if k1 < 1 or k2 < 1 or k2 != rec["guard_drains"]:
        raise AssertionError(f"the gRPC global launched K1 {k1}x, K2 {k2}x "
                             f"({rec['guard_drains']} guard drains)")
    nat = src["native"]
    rec["native_leg"] = {
        "import_s": nat["import_s"], "global_flush_s": nat["global_flush_s"],
        "send_s": [nat[f"local_{x}"]["send_s"] for x in "ab"],
        "wire_bytes": [nat[f"local_{x}"]["wire_bytes"] for x in "ab"]}
    rec["launches"] = counts
    return rec, counts


def _fed_local(dev, t, label: str, address: str, grpc: bool):
    """A port local Server (no statsd listener; an ops port, which a
    global's fleet view pulls) forwarding to ``address`` (over
    gRPC, else HTTP), fed local ``label``'s share of ``t`` through its
    store: histograms p.h.<i> (4 samples), sets p.s.<i>, global-only
    counters p.c.<i> and gauges p.g.<label>.<i>. Started; the caller
    flushes and shuts it down."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric
    from veneur_tpu_torch.server import Server

    local = Server(Config(
        interval="86400s", hostname=f"local-{label}",
        percentiles=list(PERCENTILES), aggregates=["min", "max", "count"],
        forward_address=address, forward_use_grpc=grpc,
        forward_timeout="600s", http_address="127.0.0.1:0"), device=dev)
    local.start()
    vals, keep = t[label], t[f"{label}_keep"]
    series, nsets = len(vals), len(t["card"])
    store = local.store
    with store._lock:
        hist, sets = store.histograms, store.sets
        for i in range(series):
            hist.interner.intern(MetricKey(f"p.h.{i}", "histogram", ""), [])
        hist.ensure_capacity(series - 1)
        hist.sample_many(np.repeat(np.arange(series, dtype=np.int32), 4),
                         vals.reshape(-1), np.ones(vals.size, np.float32))
        for i in range(nsets):
            sets.interner.intern(MetricKey(f"p.s.{i}", "set", ""), [])
        sets.ensure_capacity(nsets - 1)
        sets.sample_many(t["owner"][keep], t["universe"][keep])
    for i, v in enumerate(t[f"{label}_ctr"]):
        store.process_metric(parse_metric(
            f"p.c.{i}:{int(v)}|c|#veneurglobalonly".encode()))
        store.process_metric(parse_metric(
            f"p.g.{label}.{i}:{int(v) + 0.5}|g|#veneurglobalonly".encode()))
    return local


def _proxy_globals(dev, mesh_too: bool, peers):
    """Global Servers with http_address and grpc_address, fleet_peers the
    file ``peers``, and a columnar recording sink: a dense one, and with
    ``mesh_too`` a mesh one (mesh_enabled, mesh_hosts 2, 4 x 2 on the
    card)."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server

    out = []
    for mesh in ((False, True) if mesh_too else (False,)):
        sink = _ColumnarRecorder()
        server = Server(Config(
            http_address="127.0.0.1:0", grpc_address="127.0.0.1:0",
            interval="86400s", percentiles=list(PERCENTILES),
            aggregates=["min", "max", "count"],
            hostname="mesh" if mesh else "dense", mesh_enabled=mesh,
            mesh_hosts=MESH_HOSTS if mesh else 0,
            fleet_peers=f"file://{peers}"), metric_sinks=[sink],
            device=dev, mesh=_shard_mesh(dev) if mesh else None)
        server.start()
        out.append((server, sink))
    return out


def _forward_pair(dev, t, globs, grpc_address: str, http_address: str,
                  rec: dict, peers) -> int:
    """Local A over gRPC to ``grpc_address``, then local B over HTTP to
    ``http_address``; each forward lands in ``globs`` (their imports,
    summed, reach what the local sent) before the next starts. Returns
    the metrics sent. Each local forwards once: it stops without the
    final flush, after the globals' fleet views pulled it (``peers``
    names it and the proxy) and kept it: they serve its flush to
    /debug/trace after it stopped. Each local's trace id goes into
    ``rec``."""
    sent = 0
    for label, grpc, address in (("a", True, grpc_address),
                                 ("b", False, http_address)):
        local = _fed_local(dev, t, label, address, grpc)
        try:
            t0 = time.perf_counter()
            local.flush()
            if local.wait_forward(600) is not True:
                raise AssertionError(f"local {label}'s forward failed "
                                     f"({local.forwarder.errors} errors)")
            sent += local.forwarder.forwarded
            _wait_for(lambda: sum(g.store.imported for g, _ in globs)
                      >= sent, 600, f"local {label}'s metrics imported")
            rec[f"local_{label}_s"] = time.perf_counter() - t0
            rec[f"local_{label}_forwarded"] = local.forwarder.forwarded
            rec[f"local_{label}_trace_id"] = \
                local.obs_timeline.entries()[-1]["trace_id"]
            rec["peers"].append(f"127.0.0.1:{local.ops_server.port}")
            peers.write_text("".join(f"{p}\n" for p in rec["peers"]))
            for g, _ in globs:
                g.fleet_aggregator.refresh(force=True)
        finally:
            # no final flush: it would forward again (the local's own
            # veneur.* timers of the first one), past what was counted
            local.crash_stop()
    if sum(g.store.imported for g, _ in globs) != sent:
        raise AssertionError("the globals imported more than was sent")
    return sent


def _global_rows(server, sink) -> tuple:
    """One flush of a global Server: ({group: {name: row}}, {extra key:
    value}, the suffixes)."""
    from veneur_tpu_torch import flusher

    flusher.flush_once(server)
    col = sink.flushes.get(timeout=120)
    groups, sfx = {}, {}
    for key, (blk, names) in _blocks_by_prefix(col, 1).items():
        groups[key] = dict(zip(names, _block_matrix(blk)))
        sfx[key] = [x.decode() for x in blk.suffixes]
    extras = {(m.name, tuple(m.tags)): m.value for m in col.extras
              if not m.name.startswith("veneur.")}
    return groups, extras, sfx


def run_proxy_tier(dev, series: int = PROXY_SERIES, sets: int = PROXY_SETS,
                   scalars: int = PROXY_SCALARS) -> dict:
    """Leg (b) of grpc_proxy: two globals (dense, and mesh 4 x 2), each
    serving /import and gRPC, behind one Proxy (HTTP and gRPC listeners)
    over a StaticDiscoverer of the two (members are their HTTP
    addresses; grpc_dial maps each to its gRPC import). Local A forwards
    over gRPC to the proxy's gRPC port, local B over HTTP to its
    /import; the same two locals forward directly to a third, dense
    global. Held: every series on exactly one global, and both used (A
    and B send every name, so HTTP and gRPC routed each series to the
    same global); the union of the two globals' rows equals the
    direct global's (counters, gauges, counts, extrema and set estimates
    exact, percentiles within rtol 1e-5); the proxies proxied every
    metric sent with no error or drop. Prints each transport's fan-out
    seconds. Returns the record."""
    import tempfile

    from veneur_tpu_torch.config import ProxyConfig
    from veneur_tpu_torch.discovery import StaticDiscoverer
    from veneur_tpu_torch.protocol import mlist
    from veneur_tpu_torch.proxy.proxy import Proxy

    # the global_merge traffic's shapes at the proxy tier's size
    t = _global_merge_traffic(series, sets, scalars)
    rec = {"histogram_series": series, "set_series": sets,
           "global_counters": scalars, "gauges_per_local": scalars}
    tmp = tempfile.TemporaryDirectory()
    pair_peers = Path(tmp.name) / "pair.peers"
    direct_peers = Path(tmp.name) / "direct.peers"
    for f in (pair_peers, direct_peers):
        f.write_text("")
    pair = _proxy_globals(dev, True, pair_peers)
    direct = _proxy_globals(dev, False, direct_peers)
    proxy = None
    real_split = mlist.split_metric_list
    try:
        members = [f"http://127.0.0.1:{g.ops_server.port}" for g, _ in pair]
        dial = {m: f"127.0.0.1:{g.import_server.port}"
                for m, (g, _) in zip(members, pair)}
        proxy = Proxy(ProxyConfig(http_address="127.0.0.1:0",
                                  grpc_forward_address="127.0.0.1:0",
                                  forward_timeout="600s"),
                      discoverer=StaticDiscoverer(members),
                      grpc_dial=dial.get)
        fan = {"http_fan_out_s": 0.0, "grpc_fan_out_s": 0.0,
               "grpc_split_s": 0.0}
        proxy._fan_out = _timed_into(fan, "http_fan_out_s", proxy._fan_out)
        mlist.split_metric_list = _timed_into(fan, "grpc_split_s",
                                              real_split)
        proxy.start()
        gsrv = proxy.grpc_server
        gsrv.send_metrics = _timed_into(fan, "grpc_fan_out_s",
                                        gsrv.send_metrics)
        proxied = {"peers": [f"127.0.0.1:{proxy.port}"]}
        sent = _forward_pair(dev, t, pair, f"127.0.0.1:{gsrv.port}",
                             f"http://127.0.0.1:{proxy.port}", proxied,
                             pair_peers)
        mlist.split_metric_list = real_split
        dsrv = direct[0][0]
        direct_rec = {"peers": []}
        dsent = _forward_pair(
            dev, t, direct, f"127.0.0.1:{dsrv.import_server.port}",
            f"http://127.0.0.1:{dsrv.ops_server.port}", direct_rec,
            direct_peers)
        rec.update(proxied_leg=proxied, direct_leg=direct_rec, **fan)
        rec["proxy"] = proxy.vars()
        if not (sent == dsent == proxied["local_a_forwarded"]
                + proxied["local_b_forwarded"]
                and gsrv.proxied == proxied["local_a_forwarded"]
                and proxy.proxied == proxied["local_b_forwarded"]
                and gsrv.forward_errors == proxy.forward_errors == 0
                and gsrv.dropped == proxy.dropped == 0):
            raise AssertionError(f"proxy counts: sent {sent}, direct "
                                 f"{dsent}, {rec['proxy']}")
        got = [_global_rows(g, sink) for g, sink in pair]
        want = _global_rows(*direct[0])
        # the fleet trace plane: the HTTP local's trace crosses the proxy
        # (its fan-out re-parents the dense global's import), the gRPC
        # local's direct one stitches without a proxy hop
        rec["trace_via_proxy"] = _stitched(
            pair[0][0].ops_server.port, proxied["local_b_trace_id"],
            ("local.flush", "proxy.fan_out", "global.import",
             "global.flush"))
        rec["trace_grpc_direct"] = _stitched(
            dsrv.ops_server.port, direct_rec["local_a_trace_id"],
            ("local.flush", "global.import", "global.flush"))
        if "proxy.fan_out" in {h for h, _ in
                                rec["trace_grpc_direct"]["hops"]}:
            raise AssertionError("the direct gRPC trace holds a proxy hop")
    finally:
        mlist.split_metric_list = real_split
        if proxy is not None:
            proxy.shutdown()
        for g, _ in pair + direct:
            g.shutdown()
        tmp.cleanup()
    rec["per_global"] = {}
    for (g, _), (groups, extras, _) in zip(pair, got):
        rec["per_global"][g.config.hostname] = {
            k: len(v) for k, v in groups.items()}
        rec["per_global"][g.config.hostname]["extras"] = len(extras)
    wgroups, wextras, wsfx = want
    for key in ("h", "s"):
        parts = [groups.get(key, {}) for groups, _, _ in got]
        if not all(parts) or set(parts[0]) & set(parts[1]):
            raise AssertionError(f"group {key}: a global holds none, or a "
                                 "series is on both")
        union = {**parts[0], **parts[1]}
        if set(union) != set(wgroups[key]):
            raise AssertionError(f"group {key}: the globals' series differ "
                                 "from the direct global's")
        names = sorted(union)
        g = np.stack([union[n] for n in names])
        w = np.stack([wgroups[key][n] for n in names])
        pc = [i for i, x in enumerate(wsfx[key]) if x.endswith("percentile")]
        other = [i for i in range(len(wsfx[key])) if i not in pc]
        if any(sfx[key] != wsfx[key] for _, _, sfx in got):
            raise AssertionError(f"group {key}: suffixes differ")
        if not np.array_equal(g[:, other], w[:, other]):
            raise AssertionError(f"group {key}: counts, extrema or "
                                 "estimates differ from the direct global")
        if pc:
            rel = np.abs(g[:, pc] - w[:, pc]) / np.maximum(
                np.abs(w[:, pc]), 1e-30)
            rec[f"{key}_pct_rel_err_vs_direct"] = float(rel.max())
            if rel.max() > 1e-5:
                raise AssertionError(f"group {key}: percentiles off the "
                                     f"direct global's by {rel.max():.3g}")
    union_x = {**got[0][1], **got[1][1]}
    if len(union_x) != len(got[0][1]) + len(got[1][1]) \
            or union_x != wextras or len(wextras) != 3 * scalars:
        raise AssertionError("counters or gauges differ from the direct "
                             "global's")
    return rec


def phase_grpc_proxy(dev, card: str) -> dict:
    """gRPC forward and import at full width (run_grpc_global: native_
    merge's 2 x 1,048,576-series frames over gRPC, rows bit for bit the
    native:// global's), then the proxy tier at 32,768 series a local
    (run_proxy_tier); a line a leg. Returns the launch counts of both
    (the JSON leg's locals and globals included)."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    t_phase = time.perf_counter()
    counts = {}
    for name, run in (("grpc_global", lambda: run_grpc_global(dev)),
                      ("proxy_tier", lambda: (run_proxy_tier(dev), None))):
        _peak_reset(dev)
        _reset_counts(tc)
        t0 = time.perf_counter()
        rec, c = run()
        c = c or _counts(tc)
        rec["subphase_s"] = time.perf_counter() - t0
        rec["max_memory_allocated"] = _peak_bytes(dev)
        if name == "proxy_tier":
            # four locals and three globals each flush once
            if c["drain_quantile.launches"] < 7:
                raise AssertionError(f"the proxy tier launched {c}")
            rec["launches"] = c
        _add_counts(counts, c)
        gc.collect()
        emit({"phase": "grpc_proxy", "subphase": name, "card": card, **rec})
    emit({"phase": "grpc_proxy", "card": card, "launches": counts,
          "phase_s": time.perf_counter() - t_phase})
    return counts


# the fleet_trace phase: the fleet trace plane on a traced 1M-series global

FT_SERIES = 1 << 20              # the local's histogram series, in bulk
FT_UDP_SERIES = 4096             # more over its UDP lanes, 4 samples each
FT_EVERY = 16                    # interval 2: every 16th series, shifted
FT_SHIFT = 1000.0


def _own_values(col) -> dict:
    """The server's own rows (veneur.*) of a ColumnarFlush, blocks and
    extras: {(name with its suffix, joined tags): value}."""
    from veneur_tpu_torch.core.columnar import arena_strings

    out = {(m.name, ",".join(m.tags)): m.value for m in col.extras
           if m.name.startswith("veneur.")}
    for blk in col.blocks:
        names, tags = arena_strings(blk.names), arena_strings(blk.tags)
        own = np.array([x.startswith("veneur.") for x in names], bool)
        if not len(own):
            continue
        for i in np.nonzero(own[blk.rows])[0].tolist():
            row = int(blk.rows[i])
            sfx = blk.suffixes[blk.suffix_idx[i]].decode()
            out[(names[row] + sfx, tags[row])] = float(blk.values[i])
    return out


def _stitched(port: int, tid: int, hops: tuple) -> dict:
    """GET /debug/trace?id=<tid> on a Server's or a proxy's ops port:
    every hop named in ``hops`` is there under the one trace id, their
    first occurrences in wall order; a missing hop or another trace id
    fails. Returns the hops with their durations, the e2e wall time and
    hop_coverage_ratio (printed, not gated)."""
    status, body = _http_get(port, f"/debug/trace?id={tid}")
    if status != 200:
        raise AssertionError(f"/debug/trace?id={tid}: HTTP {status} "
                             f"{body[:200]}")
    data = json.loads(body)
    names = [h["hop"] for h in data["hops"]]
    if data["trace_id"] != tid or any(h.get("trace_id", tid) != tid
                                      for h in data["hops"]):
        raise AssertionError(f"trace {tid} split: {data['hops']}")
    missing = [h for h in hops if h not in names]
    first = [names.index(h) for h in hops if h in names]
    if missing or first != sorted(first):
        raise AssertionError(f"trace {tid}: hops {names}, want {hops} in "
                             "wall order")
    return {"hops": [[h["hop"], h["duration_ns"]] for h in data["hops"]],
            "e2e_wall_ns": data["e2e_wall_ns"],
            "hop_coverage_ratio": data["hop_coverage_ratio"],
            "gaps": len(data.get("gaps", ()))}


def _delta(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after
            if after.get(k, 0) != before.get(k, 0)}


def run_fleet_trace(dev, series: int = FT_SERIES,
                    udp_series: int = FT_UDP_SERIES) -> tuple:
    """A port local Server (UDP lanes, forward_use_grpc) and a port global
    Server (grpc_address, http_address, obs_enabled, fleet_peers naming
    the local through a file://) on ``dev``. Interval 1: ``udp_series``
    histogram series over the local's lanes (so each chunk carries an
    ingest stamp), then ``series`` through its store; interval 2: every
    FT_EVERY-th series takes 4 samples shifted +FT_SHIFT. Each local
    flush forwards its packed digests as MetricList frames over gRPC
    with X-Veneur-Trace in the call metadata; the global's imports (K2
    on the guard drains of interval 2's frames, which meet rows that
    hold interval 1) park their global.import hops, and one global flush
    (K1) publishes them. Held: each local flush's trace id stitches
    local.flush -> global.import -> global.flush at the global's
    /debug/trace, every import hop under it; the global's next flush
    emits veneur.fleet.e2e_age_ns.*, each value no more than the time
    from the first UDP send to the end of the global's flush and no less
    than from the end of the UDP feed to its start; /debug/fleet lists
    the local, not stale, and after the local stops serves it stale.
    Returns the record and the launch counts."""
    import tempfile

    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.forward import grpc_forward
    from veneur_tpu_torch.obs import kernels as obs_kernels
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.parser import MetricKey
    from veneur_tpu_torch.server import Server

    rng = np.random.default_rng(SEED + 71)
    common = dict(interval="86400s", percentiles=list(PERCENTILES),
                  aggregates=["min", "max", "count"],
                  max_series=INGEST_MAX_SERIES)
    rec = {"histogram_series": series, "udp_series": udp_series,
           "interval2_series": series // FT_EVERY}
    tmp = tempfile.TemporaryDirectory()
    peers = Path(tmp.name) / "fleet.peers"
    peers.write_text("")
    gsink = _ColumnarRecorder()
    glob = Server(Config(http_address="127.0.0.1:0",
                         grpc_address="127.0.0.1:0", hostname="ft-global",
                         fleet_peers=f"file://{peers}", **common),
                  metric_sinks=[gsink], device=dev)
    glob.start()
    local = None
    real_import = grpc_forward.import_metric_list
    try:
        local = Server(Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"],
            http_address="127.0.0.1:0", hostname="ft-local",
            forward_address=f"127.0.0.1:{glob.import_server.port}",
            forward_use_grpc=True, forward_timeout="600s", **common),
            metric_sinks=[_ColumnarRecorder()], device=dev)
        local.start()
        local_addr = f"127.0.0.1:{local.ops_server.port}"
        peers.write_text(local_addr + "\n")
        udp = rng.gamma(2.0, 10.0, (udp_series, 4))
        lines = [f"ft.u.{i}:{x:.4f}|h" for i in range(udp_series)
                 for x in udp[i]]
        t_send = time.time()
        _send_lines(local.statsd_addrs[0][1], lines)
        _wait_processed(local, len(lines), 120)
        t_udp_done = time.time()
        vals = rng.gamma(2.0, 10.0, (series, 4)).astype(np.float32)
        store = local.store
        t0 = time.perf_counter()
        with store._lock:
            hist = store.histograms
            rows = np.array([hist.interner.intern(
                MetricKey(f"ft.h.{i}", "histogram", ""), [])
                for i in range(series)], np.int32)
            hist.ensure_capacity(int(rows.max()))
            # weight 2 (a 0.5 sample rate): each row's mass reaches the
            # shift guard's minimum, so interval 2 trips it
            hist.sample_many(np.repeat(rows, 4), vals.reshape(-1),
                             np.full(vals.size, 2.0, np.float32))
        _sync(dev)
        rec["feed_s"] = time.perf_counter() - t0
        _reset_counts(tc)
        marks = []
        real_fwd = local.forward_fn

        def forward(state, deadline=None, parent_span=None, trace_ctx=None):
            # the local's flush launches end where its forward begins
            marks.append((_counts(tc), obs_kernels.dispatch_snapshot(),
                          time.perf_counter()))
            return real_fwd(state, deadline=deadline,
                            parent_span=parent_span, trace_ctx=trace_ctx)

        local.forward_fn = forward
        probe = _ImportProbe(dev, glob.store, grpc_forward,
                             "import_metric_list")
        tids, launches = [], {"local_flush": {}, "global_import": {}}
        scopes = {"global_import": {}}
        with probe:
            for interval in range(2):
                if interval:
                    # the flush swapped the generation: intern again
                    shifted = (FT_SHIFT + rng.gamma(2.0, 10.0, (
                        series // FT_EVERY, 4))).astype(np.float32)
                    with store._lock:
                        hist = store.histograms
                        hot = np.array([hist.interner.intern(
                            MetricKey(f"ft.h.{i}", "histogram", ""), [])
                            for i in range(0, series, FT_EVERY)], np.int32)
                        hist.ensure_capacity(int(hot.max()))
                        hist.sample_many(np.repeat(hot, 4),
                                         shifted.reshape(-1),
                                         np.ones(shifted.size, np.float32))
                c0, d0 = _counts(tc), obs_kernels.dispatch_snapshot()
                t0 = time.perf_counter()
                local.flush()
                rec[f"local_flush_{interval + 1}_s"] = \
                    time.perf_counter() - t0
                if local.wait_forward(600) is not True:
                    raise AssertionError(f"the local's forward failed "
                                         f"({local.forwarder.errors})")
                cf, df, tf = marks[-1]
                rec[f"forward_{interval + 1}_s"] = time.perf_counter() - tf
                _add_counts(launches["local_flush"], _delta(cf, c0))
                _add_counts(launches["global_import"],
                            _delta(_counts(tc), cf))
                _add_counts(scopes["global_import"],
                            _delta(obs_kernels.dispatch_snapshot(), df))
                lentry = local.obs_timeline.entries()[-1]
                tids.append(lentry["trace_id"])
                rec[f"local_oldest_sample_age_{interval + 1}_ns"] = \
                    lentry.get("oldest_sample_age_ns")
            fwd = local.forwarder
            rec.update(frames=len(fwd.post_content_lengths),
                       wire_bytes=sum(fwd.post_content_lengths))
            c1, d1 = _counts(tc), obs_kernels.dispatch_snapshot()
            probe.final_drain()
        grpc_forward.import_metric_list = real_import
        probe.record(rec)
        _add_counts(launches["global_import"], _delta(_counts(tc), c1))
        _add_counts(scopes["global_import"],
                    _delta(obs_kernels.dispatch_snapshot(), d1))
        hops = [h for h in glob.obs_hops.peek() if h["hop"] ==
                "global.import"]
        if {h.get("trace_id") for h in hops} != set(tids):
            raise AssertionError(f"import hops under "
                                 f"{ {h.get('trace_id') for h in hops} }, "
                                 f"the local flushed {tids}")
        rec["import_hops"] = len(hops)
        # the global's flush of both intervals (K1)
        c2, d2 = _counts(tc), obs_kernels.dispatch_snapshot()
        t_flush0 = time.time()
        t0 = time.perf_counter()
        glob.flush()
        col = gsink.flushes.get(timeout=600)
        rec["global_flush_s"] = time.perf_counter() - t0
        t_flushed = time.time()
        launches["global_flush"] = _delta(_counts(tc), c2)
        scopes["global_flush"] = _delta(obs_kernels.dispatch_snapshot(), d2)
        rec["global_rows"] = len(col)
        del col
        gentry = glob.obs_timeline.entries()[-1]
        if not set(tids) <= set(gentry.get("import_traces", ())):
            raise AssertionError(f"the global flush published "
                                 f"{gentry.get('import_traces')}, not {tids}")
        rec["global_e2e_age_ns"] = gentry["e2e_age_ns"]
        rec["traces"] = [_stitched(glob.ops_server.port, tid, (
            "local.flush", "global.import", "global.flush"))
            for tid in tids]
        # the e2e age's rows: its sample went through self_timers, so the
        # next flush emits it (K1 over that group)
        c3 = _counts(tc)
        glob.flush()
        own = _own_values(gsink.flushes.get(timeout=600))
        launches["global_next_flush"] = _delta(_counts(tc), c3)
        e2e = {name[len("veneur.fleet.e2e_age_ns"):]: v
               for (name, _), v in own.items()
               if name.startswith("veneur.fleet.e2e_age_ns.")}
        lo, hi = (t_flush0 - t_udp_done) * 1e9, (t_flushed - t_send) * 1e9
        if e2e.get(".count", 0) < 1 or not all(
                lo <= e2e[s] <= hi for s in (".min", ".max",
                                             ".50percentile",
                                             ".99percentile")):
            raise AssertionError(f"veneur.fleet.e2e_age_ns {e2e} outside "
                                 f"[{lo:.4g}, {hi:.4g}] ns")
        rec["e2e_age_ns"] = {"p50": e2e[".50percentile"],
                             "p99": e2e[".99percentile"],
                             "count": e2e[".count"], "bounds": [lo, hi]}
        # /debug/fleet: the local pulled fresh, then stale once it stops
        _, body = _http_get(glob.ops_server.port, "/debug/fleet?refresh=1")
        view = json.loads(body)["peers"].get(local_addr)
        if not view or not view["ok"] or view["stale"]:
            raise AssertionError(f"/debug/fleet before the stop: {view}")
        local.crash_stop()
        local = None
        _, body = _http_get(glob.ops_server.port, "/debug/fleet?refresh=1")
        view = json.loads(body)["peers"].get(local_addr)
        if not view or view["ok"] or not view["stale"]:
            raise AssertionError(f"/debug/fleet after the stop: {view}")
        rec["fleet_view_stale_after_stop"] = True
        if not (launches["global_import"].get(
                "compress_presorted.launches", 0) >= 1
                and scopes["global_import"].get("drain.digest.dense", 0) >= 1
                and launches["global_flush"].get(
                    "drain_quantile.launches", 0) >= 1
                and scopes["global_flush"].get("flush.digest.dense", 0) >= 1):
            raise AssertionError(f"the global's kernels: {launches}, "
                                 f"scopes {scopes}")
        rec.update(launches=launches, scopes=scopes)
    finally:
        grpc_forward.import_metric_list = real_import
        if local is not None:
            local.crash_stop()
        glob.shutdown()
        tmp.cleanup()
    return rec, _counts(tc)


def phase_fleet_trace(dev, card: str) -> dict:
    """The fleet trace plane at full width (run_fleet_trace): one line.
    Returns the launch counts."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    _peak_reset(dev)
    _reset_counts(tc)
    t0 = time.perf_counter()
    rec, counts = run_fleet_trace(dev)
    rec.update(phase_s=time.perf_counter() - t0,
               max_memory_allocated=_peak_bytes(dev))
    gc.collect()
    emit({"phase": "fleet_trace", "card": card, **rec})
    return counts


def _udp_lines(rng, series: int):
    """A few hundred DogStatsD lines of the kinds a local forwards:
    global-only counters and gauges, histograms, sets. Returns (lines,
    the numpy reference: counter totals, last gauges, histogram samples,
    set members)."""
    lines, ref = [], {"c": {}, "g": {}, "h": {}, "s": {}}
    for n in range(4):
        for i in range(series):
            v = int(rng.integers(1, 10))
            ref["c"][f"u.c.{i}"] = ref["c"].get(f"u.c.{i}", 0) + v
            lines.append(f"u.c.{i}:{v}|c|#veneurglobalonly")
            ref["g"][f"u.g.{i}"] = float(n * 10 + i)
            lines.append(f"u.g.{i}:{n * 10 + i}|g|#veneurglobalonly")
            x = float(f"{rng.gamma(2.0, 10.0):.4f}")
            ref["h"].setdefault(f"u.h.{i}", []).append(x)
            lines.append(f"u.h.{i}:{x}|h")
            m = f"m{int(rng.integers(0, 20))}"
            ref["s"].setdefault(f"u.s.{i}", set()).add(m)
            lines.append(f"u.s.{i}:{m}|s")
    return lines, ref


def run_server_global(dev, compat: bool, series: int = 1 << 16,
                      udp_series: int = 25, native: bool = False,
                      packed: bool = True):
    """A port global Server (http_address) and a port local Server (UDP
    in, forward_address pointing at the global) in this process on
    ``dev``. DogStatsD lines go over UDP, then ``series`` histogram
    series fill the local through its store; one local flush POSTs the
    deflated JSON body to /import, the global's pool merges it, and one
    global flush emits into a channel sink. The emissions are held to
    the numpy reference of what was sent. With ``native`` the global
    serves native_import_address instead and the local forwards to
    native://...: its flush packs the digests on the card (dense with
    ``packed`` False: forward_packed_digests false) and sends MetricList
    frames, which the global's NativeImportServer imports."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.samplers.parser import MetricKey
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    rng = np.random.default_rng(SEED + 4)
    pcts = [0.25, 0.5, 0.99]
    common = dict(interval="3600s", percentiles=pcts,
                  aggregates=["min", "max", "count"], hostname="smoke")
    sink = ChannelMetricSink()
    listen = ({"native_import_address": "127.0.0.1:0"} if native
              else {"http_address": "127.0.0.1:0"})
    glob = Server(Config(**listen, **common), metric_sinks=[sink],
                  device=dev)
    rec = {"reference_compatible": compat, "histogram_series": series,
           "transport": "native" if native else "http"}
    if native:
        rec["packed"] = packed
    glob.start()
    try:
        rec["import_s"] = 0.0
        if native:
            nsrv = glob.native_import_server
            nsrv._merge = _timed_into(rec, "import_s", nsrv._merge)
            address = f"native://127.0.0.1:{nsrv.port}"
        else:
            pool = glob.ops_server.import_pool
            pool._handle = _timed_into(rec, "import_s", pool._handle)
            address = f"http://127.0.0.1:{glob.ops_server.port}"
        local = Server(Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"],
            forward_address=address, forward_packed_digests=packed,
            forward_reference_compatible=compat, forward_timeout="600s",
            **common), device=dev)
        local.start()
        try:
            lines, ref = _udp_lines(rng, udp_series)
            port = local.statsd_addrs[0][1]
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for i in range(0, len(lines), 8):
                    tx.sendto("\n".join(lines[i:i + 8]).encode(),
                              ("127.0.0.1", port))
            deadline = time.time() + 60
            while local.store.processed < len(lines):
                if time.time() > deadline:
                    raise AssertionError(
                        f"local processed {local.store.processed} of "
                        f"{len(lines)} lines")
                time.sleep(0.05)
            vals = rng.gamma(2.0, 10.0, (series, 4)).astype(np.float32)
            with local.store._lock:
                hist = local.store.histograms
                base = len(hist)
                for i in range(series):
                    hist.interner.intern(
                        MetricKey(f"b.h.{i}", "histogram", ""), [])
                hist.ensure_capacity(base + series - 1)
                hist.sample_many(
                    np.repeat(np.arange(base, base + series,
                                        dtype=np.int32), 4),
                    vals.reshape(-1), np.ones(vals.size, np.float32))
            fwd = local.forwarder
            rec["body_build_s"] = 0.0
            if not native:
                fwd.body = _timed_into(rec, "body_build_s", fwd.body)
            t0 = time.perf_counter()
            local.flush()
            rec["local_flush_s"] = time.perf_counter() - t0
            if local.wait_forward(600) is not True:
                raise AssertionError(f"forward failed ({fwd.errors} errors)")
            rec["forwarded"] = fwd.forwarded
            rec["retries"] = fwd.retries
            rec["post_s"] = sum(fwd.post_durations)
            rec["body_bytes"] = sum(fwd.post_content_lengths)
            if native:
                # one forward: the digest frames, then the rest; each
                # frame is merged before its ack, so the forward's end
                # is the import's
                rec["body_build_s"] = sum(fwd.encode_durations)
                rec["frames"] = len(fwd.post_content_lengths)
                if rec["frames"] < 2 or nsrv.import_errors:
                    raise AssertionError(
                        f"native forward: {rec['frames']} frames, "
                        f"{nsrv.import_errors} import errors")
            else:
                # streaming forward: the histogram group's planes POST as
                # a part of their own, the rest of the state as a second
                # body
                posts = len(fwd.post_durations)
                if posts < 2:
                    raise AssertionError(f"the local POSTed {posts} "
                                         "bodies; streaming should have "
                                         "split it")
                rec["posts"] = posts
                deadline = time.time() + 600
                while pool.merged_batches + pool.failed_batches < posts:
                    if time.time() > deadline:
                        raise AssertionError("the global never merged the "
                                             "body")
                    time.sleep(0.05)
                if pool.failed_batches or glob.import_errors:
                    raise AssertionError(f"import failed: "
                                         f"{glob.import_errors} metric "
                                         "errors")
            t0 = time.perf_counter()
            glob.flush()
            rec["global_flush_s"] = time.perf_counter() - t0
            # the global's import spans re-enter it before this flush
            # (veneur.import.metrics_total): not the local's rows
            rows = [m for m in sink.get_flush(timeout=60)
                    if not m.name.startswith("veneur.")]
        finally:
            local.shutdown()
    finally:
        glob.shutdown()
    rec["imported"] = (glob.native_import_server.received if native
                       else glob.imported_metrics)
    rec["overload"] = [srv.overload.snapshot() for srv in (local, glob)]
    by = {m.name: m.value for m in rows}
    want_rows = (udp_series * (2 + 1 + len(pcts))
                 + series * len(pcts))
    if len(rows) != want_rows:
        raise AssertionError(f"global emitted {len(rows)} rows, want "
                             f"{want_rows}")
    for name, total in ref["c"].items():
        if by[name] != total:
            raise AssertionError(f"{name}: {by[name]} != {total}")
    for name, last in ref["g"].items():
        if by[name] != last:
            raise AssertionError(f"{name}: {by[name]} != {last}")
    for name, members in ref["s"].items():
        if abs(by[name] - len(members)) > 0.02 * len(members) + 0.5:
            raise AssertionError(f"{name}: estimate {by[name]} vs "
                                 f"{len(members)} members")
    worst = 0.0
    for name, samples in ref["h"].items():
        raw = np.float32(samples)
        span = float(raw.max() - raw.min()) or 1.0
        for p in pcts:
            err = abs(by[f"{name}.{int(p * 100)}percentile"]
                      - _digest_reference(raw, [p])[0])
            worst = max(worst, err / span)
    for i in np.random.default_rng(SEED + 5).choice(series, 512,
                                                    replace=False):
        span = float(vals[i].max() - vals[i].min())
        got = [by[f"b.h.{i}.{int(p * 100)}percentile"] for p in pcts]
        worst = max(worst, float(np.max(np.abs(
            np.array(got) - _digest_reference(vals[i], pcts)))) / span)
    # each series' digest holds its samples as centroids (4 a series in
    # bulk, 4 over UDP), so the global's percentiles are exact up to
    # float32 rounding; ROADMAP's 0.02 x span is the contract
    if worst > 0.02:
        raise AssertionError(f"global percentiles off by {worst:.3g} "
                             "of the span")
    rec["pct_err_vs_exact_digest"] = worst
    return rec


def _timed_into(rec: dict, key: str, fn):
    """fn, adding its wall seconds to rec[key] each call."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            rec[key] += time.perf_counter() - t0
    return run


def phase_server_global(dev, card: str):
    """run_server_global in our structured body format, then in the
    reference's (gob digests, axiomhq sets, LE scalars), then over the
    framed-TCP lane (native://, native_import_address) with packed
    digests and with forward_packed_digests false. Returns the launch
    counts of the four runs."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    _reset_counts(tc)
    recs = [run_server_global(dev, compat) for compat in (False, True)]
    recs += [run_server_global(dev, False, native=True, packed=packed)
             for packed in (True, False)]
    counts = _counts(tc)
    # a local flush and a global flush per run
    if counts["drain_quantile.launches"] < 8:
        raise AssertionError(f"server_global launched K1 "
                             f"{counts['drain_quantile.launches']}x")
    emit({"phase": "server_global", "card": card, "runs": recs,
          "launches": counts})
    return counts


# the ingest phase: the default UDP lane fleet of a Server on the card

INGEST_DGRAM = 1432              # the DogStatsD clients' default payload
INGEST_SENDERS = 2
INGEST_SOURCE_SOCKETS = 16       # a sender's flows: REUSEPORT hashes each
INGEST_MAX_WINDOW = 4096         # datagrams in flight, at most
INGEST_INTERVAL_S = 86400        # the flushes are driven, not ticked
# an ingest flush's wall, the busy seconds of its stages and its bodies
FLUSH_KEYS = ("flush_s", "dispatch_s", "fetch_s", "emit_s", "serialize_s",
              "post_s", "post_max_s", "post_retries", "receiver_max_s",
              "gc_pause_s", "gc_pause_max_s", "python_gap_max_s",
              "emission_share",
              "chunks", "bodies",
              "series_posted", "body_bytes_deflated", "body_bytes_inflated",
              "rows_flushed", "k1_launches")
INGEST_PERCENTILES = (0.5, 0.75, 0.99)   # example.yaml's
# the ingest Server's series cap: a 1M-series host raises the default
# 2^20, whose freeze (70%) and cap would spill a third of its series
INGEST_MAX_SERIES = 1 << 21
# the ingest phase's histogram series: 1,048,576 until the mesh phase
# came (the phase took 137-170 s at 1M on an NVIDIA H100 80GB HBM3 at
# 700 W), 524,288 until the fleet_ha phase came (109 s); cut to keep the
# script inside its time
INGEST_ROWS = 1 << 18
# the unpaced burst's 64-line cycle (one line a datagram)
_BURST_LINE = "ingest.h.%d:%d.5|h|#az:z%d,svc:s%d"

# A load generator in its own process. It imports recvmmsg.py by path
# (standard library only), so it never imports torch. "paced" sends the
# datagram ranges named on stdin and answers "done <n>" each; "blast"
# sends a fixed cycle for a given time, as fast as sendmmsg goes.
_SENDER = r'''
import os, socket, sys, time
from array import array
sys.path.insert(0, os.path.join(os.getcwd(), "veneur_tpu_torch", "ingest"))
from recvmmsg import BatchSender
mode, port, arg = sys.argv[1], int(sys.argv[2]), sys.argv[3]
socks = []
for _ in range(SOURCE_SOCKETS):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.connect(("127.0.0.1", port))
    socks.append(s)


def send_all(sock, payloads):
    sent, idle = 0, 0
    while sent < len(payloads):
        n = BatchSender(sock, payloads[sent:sent + 1024]).send_cycle()
        sent += n
        idle = idle + 1 if n == 0 else 0
        if idle > 1000:
            raise OSError("sendmmsg sent nothing 1000 times")
    return sent


if mode == "paced":
    lens = array("I")
    with open(arg + ".len", "rb") as f:
        lens.frombytes(f.read())
    with open(arg + ".bin", "rb") as f:
        blob = f.read()
    payloads, off = [], 0
    for n in lens:
        payloads.append(blob[off:off + n])
        off += n
    for line in sys.stdin:
        a, b = map(int, line.split())
        total = sum(send_all(s, payloads[a + k:b:len(socks)])
                    for k, s in enumerate(socks))
        print("done", total, flush=True)
else:
    msgs = [(BURST_LINE % (i, i % 97, i % 4, i % 64)).encode()
            for i in range(64)]
    senders = [BatchSender(s, msgs[(i % 2) * 32:(i % 2) * 32 + 32])
               for i, s in enumerate(socks)]
    end = time.time() + float(arg)
    i = 0
    while time.time() < end:
        for _ in range(3):
            senders[i % len(senders)].send_cycle()
            i += 1
        time.sleep(0.001)
'''


def _burst_lines() -> list:
    return [(_BURST_LINE % (i, i % 97, i % 4, i % 64)).encode()
            for i in range(64)]


def _sender_code() -> str:
    return (_SENDER.replace("BURST_LINE", repr(_BURST_LINE))
            .replace("SOURCE_SOCKETS", str(INGEST_SOURCE_SOCKETS)))


def _pack_lines(lines, limit: int = INGEST_DGRAM, units=None) -> dict:
    """DogStatsD lines packed greedily, in order, into datagrams of at
    most ``limit`` bytes that never split a unit (``units``: the sorted
    first line of each unit, from 0; default every line its own unit):
    the blob/d_off/d_len layout _PacedSenders sends, plus each
    datagram's line count."""
    n = len(lines)
    lens = np.fromiter(map(len, lines), np.int64, n)
    blob = "\n".join(lines).encode()
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    ends = starts + lens
    units = np.arange(n + 1) if units is None else np.r_[units, n]
    unit_ends = ends[units[1:] - 1]
    cuts = [0]
    while cuts[-1] < len(units) - 1:
        cuts.append(max(cuts[-1] + 1, int(np.searchsorted(
            unit_ends, starts[units[cuts[-1]]] + limit, "right"))))
    cuts = units[np.array(cuts)]
    d_off = starts[cuts[:-1]]
    return {"blob": blob, "d_off": d_off,
            "d_len": ends[cuts[1:] - 1] - d_off,
            "d_lines": np.diff(cuts), "lines": n}


def _ingest_traffic(rows: int, set_series: int, scalars: int, raws: int):
    """The ingest phase's DogStatsD traffic, from the seed: ``rows``
    histogram series with 2 tags, 8 samples each in units of 1/8 (exact
    in float32; a quarter of the series at @0.5), ``set_series`` sets of
    16 members, ``scalars`` counters (4 samples, every 8th at @0.1) and
    gauges (one sample), ``raws`` events and service checks (one status
    series each). As in the
    store phase, every series' first four samples come first, each
    series' four together, and the last four, shifted by +1000, after
    everything else, so the shift guard drains through K2 and a series'
    samples bin in one drain a half. Lines are packed greedily into
    datagrams of at most 1,432 bytes that never split a series' four
    lines. One generator per array, so a smaller call draws the first
    series of a larger."""
    gens = iter([np.random.default_rng(s) for s in
                 np.random.SeedSequence(SEED + 6).spawn(5)])
    q = np.concatenate(
        [np.round(next(gens).gamma(2.0, 10.0, (rows, 4)) * 8),
         np.round((1000.0 + next(gens).gamma(2.0, 10.0, (rows, 4))) * 8)],
        axis=1).astype(np.int64)
    members = next(gens).integers(0, 1 << 48, (set_series, 16))
    cvals = next(gens).integers(1, 1000, (4, scalars))
    gvals = np.round(next(gens).normal(0.0, 1000.0, scalars), 3)
    head = [f"ingest.h.{i}:" for i in range(rows)]
    tail = [f"|h{'|@0.5' if i % 4 == 0 else ''}|#az:z{i % 4},svc:s{i % 64}"
            for i in range(rows)]
    vals = (q / 8.0).tolist()

    def half(k0):
        return [h + repr(v) + t for h, t, vs in zip(head, tail, vals)
                for v in vs[k0:k0 + 4]]

    lines = half(0)
    lines += [f"ingest.s.{j}:u{m}|s" for j, ms in enumerate(members.tolist())
              for m in ms]
    for r in range(4):
        lines += [f"ingest.c.{i}:{v}|c{'|@0.1' if i % 8 == 0 else ''}"
                  for i, v in enumerate(cvals[r].tolist())]
    lines += [f"ingest.g.{i}:{v!r}|g" for i, v in enumerate(gvals.tolist())]
    lines += [ln for i in range(raws) for ln in (
        "_e{5,4}:title|text", f"_sc|ingest.check.{i}|{i % 4}|m:m{i}")]
    middle = len(lines) - 4 * rows
    lines += half(4)
    del head, tail, vals
    # the units a datagram never splits: a series' four lines, or a line
    units = np.concatenate([np.arange(0, 4 * rows, 4),
                            4 * rows + np.arange(middle),
                            4 * rows + middle + np.arange(0, 4 * rows, 4)])
    packed = _pack_lines(lines, units=units)
    del lines
    mult = int(np.float32(1.0) / np.float32(0.1))
    weights = np.where(np.arange(scalars) % 8 == 0, mult, 1)
    return {**packed, "q": q, "members": members,
            "metric_lines": packed["lines"] - 2 * raws,
            "raw_lines": 2 * raws,
            "counters": (cvals * weights).sum(0), "gauges": gvals,
            "rows": rows, "set_series": set_series, "scalars": scalars}


def _datagrams(t) -> list:
    blob = t["blob"]
    return [blob[o:o + n] for o, n in zip(t["d_off"].tolist(),
                                           t["d_len"].tolist())]


def _udp_drops(port: int) -> int:
    """Datagrams the kernel dropped on every socket bound to ``port``
    (the drops column of /proc/net/udp and udp6)."""
    total = 0
    for path in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            with open(path) as f:
                table = f.read().splitlines()[1:]
        except OSError:
            continue
        for ln in table:
            cols = ln.split()
            if int(cols[1].rsplit(":", 1)[1], 16) == port:
                total += int(cols[-1])
    return total


class _PacedSenders:
    """INGEST_SENDERS sender processes, each owning every
    INGEST_SENDERS-th datagram of the traffic, released one window at a
    time."""

    def __init__(self, port: int, t, workdir):
        import os

        workdir.mkdir(parents=True, exist_ok=True)
        self.procs, self.counts, self.files = [], [], []
        blob = t["blob"]
        for s in range(INGEST_SENDERS):
            offs = t["d_off"][s::INGEST_SENDERS].tolist()
            lens = t["d_len"][s::INGEST_SENDERS]
            base = workdir / f"sender{s}"
            self.files += [Path(f"{base}.bin"), Path(f"{base}.len")]
            with open(f"{base}.bin", "wb") as f:
                for o, n in zip(offs, lens.tolist()):
                    f.write(blob[o:o + n])
            lens.astype(np.uint32).tofile(f"{base}.len")
            self.counts.append(len(offs))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _sender_code(), "paced", str(port),
                 str(base)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True, cwd=os.path.dirname(os.path.abspath(__file__))))

    def send(self, a: int, b: int) -> int:
        """Each sender sends its datagrams [a, b); returns how many went
        out."""
        for p in self.procs:
            p.stdin.write(f"{a} {b}\n")
            p.stdin.flush()
        sent = 0
        for p in self.procs:
            reply = p.stdout.readline().split()
            if reply[:1] != ["done"]:
                raise AssertionError(f"sender failed: {reply}")
            sent += int(reply[1])
        return sent

    def close(self):
        for p in self.procs:
            p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self.files:
            f.unlink(missing_ok=True)


def _wait_for(cond, timeout: float, what: str):
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _instrument(store, fleet) -> dict:
    """Per-interval time accumulators around the lanes' intern misses,
    the store's lane remap (store-side interning) and its chunk merge;
    each wrapper's accumulator has one writer thread."""
    acc = {"lane_intern_s": [0.0] * fleet.num_lanes, "store_intern_s": 0.0,
           "merge_s": 0.0}

    def timed(fn, add):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add(time.perf_counter() - t0)
        return run

    def lane_add(i):
        def add(dt):
            acc["lane_intern_s"][i] += dt
        return add

    for lane in fleet.lanes:
        lane._intern_misses = timed(lane._intern_misses,
                                    lane_add(lane.lane_id))
    store._lane_remap = timed(store._lane_remap, lambda dt: acc.__setitem__(
        "store_intern_s", acc["store_intern_s"] + dt))
    store.import_lane_chunk = timed(
        store.import_lane_chunk,
        lambda dt: acc.__setitem__("merge_s", acc["merge_s"] + dt))
    return acc


def _paced_interval(server, fleet, senders, t, window: int, acc) -> dict:
    """Send the traffic once, one window at a time (at most ``window``
    datagrams in flight, and the merger's backlog drained, before the
    next), and wait until every line is merged, handed back raw (and
    routed: events to the event worker, service checks to the store) or
    rejected."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    acc.update(lane_intern_s=[0.0] * fleet.num_lanes, store_intern_s=0.0,
               merge_s=0.0)
    before = fleet.totals()
    shed0 = server.overload.shed_total()
    changes0 = server.overload.level_changes
    events0 = len(server.event_worker)
    k2 = tc.compress_presorted.launches
    port = fleet.bound[0][1]
    per_sender = window // INGEST_SENDERS
    sent = 0
    t0 = time.perf_counter()
    for a in range(0, max(senders.counts), per_sender):
        sent += senders.send(a, a + per_sender)
        _wait_for(lambda: (fleet.totals()["packets"] - before["packets"]
                           >= sent and fleet.totals()["backlog"]
                           <= fleet.num_lanes),
                  300, "the lanes to catch up with a window")

    def settled():
        now = fleet.totals()
        return (sum(now[k] - before[k] for k in (
            "merged", "merged_raws", "parse_errors", "quarantined",
            "shed_records")) >= t["lines"]
            and len(server.event_worker) - events0 >= t["raw_lines"] // 2)

    _wait_for(settled, 600, "every line to be merged")
    wall = time.perf_counter() - t0
    after = fleet.totals()
    d = {k: after[k] - before[k] for k in after
         if isinstance(after[k], int) and k != "lanes"}
    drops = _udp_drops(port)
    rec = {"datagrams_sent": sent, "lines": t["lines"], "ingest_s": wall,
           "records_per_s": t["lines"] / wall,
           "datagrams_per_s": sent / wall,
           "syscalls_per_packet": d["syscalls"] / d["packets"],
           "kernel_drops_total": drops, "totals": d,
           "balance_ok": fleet.balance()["ok"],
           "intern_gens": [lane.gen for lane in fleet.lanes],
           "overload_shed": server.overload.shed_total() - shed0,
           "overload_level_changes": (server.overload.level_changes
                                      - changes0),
           "spilled": _spilled(server.store),
           "events": len(server.event_worker) - events0,
           "k2_launches": tc.compress_presorted.launches - k2,
           "lane_intern_s": list(acc["lane_intern_s"]),
           "store_intern_s": acc["store_intern_s"],
           "merge_s": acc["merge_s"]}
    conserved = (d["merged"] + d["raws"] + d["parse_errors"]
                 + d["quarantined"] + d["shed_records"])
    if not (sent == d["packets"] == len(t["d_len"]) and drops == 0
            and rec["balance_ok"] and conserved == t["lines"]
            and d["shed_records"] == d["shed_packets"] == 0
            and d["raws"] == d["merged_raws"] == t["raw_lines"]
            and d["parse_errors"] == d["quarantined"] == 0
            and rec["overload_shed"] == rec["spilled"] == 0
            and rec["events"] == t["raw_lines"] // 2):
        raise AssertionError(f"ingest did not conserve the traffic: {rec}")
    return rec


def _spilled(store) -> int:
    """Interns the live generation's overflow rows absorbed, summed over
    the groups."""
    return sum(getattr(store, g).spilled for g in store._GEN_GROUPS)


def _block_matrix(blk):
    """A block's emissions as an [S, suffixes] matrix of values, after
    checking that every (row, suffix) cell is emitted exactly once."""
    nsfx, n = len(blk.suffixes), len(blk.names[1])
    cell = blk.rows.astype(np.int64) * nsfx + blk.suffix_idx
    if not np.array_equal(np.bincount(cell, minlength=n * nsfx),
                          np.ones(n * nsfx, np.int64)):
        raise AssertionError("a block does not emit every (series, "
                             "suffix) exactly once")
    out = np.empty(n * nsfx, np.float64)
    out[cell] = blk.values
    return out.reshape(n, nsfx)


def _own_rows(col) -> int:
    """The emission rows of a ColumnarFlush whose series is the server's
    own (a veneur.* name), blocks and extras."""
    from veneur_tpu_torch.core.columnar import arena_strings

    own = sum(m.name.startswith("veneur.") for m in col.extras)
    for blk in col.blocks:
        mine = np.array([x.startswith("veneur.")
                         for x in arena_strings(blk.names)], bool)
        own += int(mine[blk.rows].sum()) if len(mine) else 0
    return own


def _traffic_prefix(blk):
    """The name prefix of a block's first series that is not the
    server's own (``ingest.h`` of ``ingest.h.17``), or None."""
    from veneur_tpu_torch.core.columnar import arena_strings

    for x in arena_strings(blk.names):
        if not x.startswith("veneur."):
            return x.rsplit(".", 1)[0]
    return None


def _check_ingest_flush(col, t, rec):
    """One interval's ColumnarFlush against the traffic, on the blocks'
    arrays: the row count; counters and gauges exact; on 4,096 seeded
    histogram series, the count (the sum of 1/rate) at rtol 1e-6,
    min/max exact and the percentiles within 1e-3 x span of the exact
    digest of the samples; set estimates within 1e-4 of a numpy HLL of
    the members; each service check a status row (an extra) with its
    value and message."""
    from veneur_tpu_torch.core.columnar import TYPE_COUNTER, arena_strings
    from veneur_tpu_torch.ops import hll as hll_ops

    n, sets, scalars = t["rows"], t["set_series"], t["scalars"]
    checks = t["raw_lines"] // 2
    want_rows = (n * (3 + len(INGEST_PERCENTILES)) + sets + 2 * scalars
                 + checks)
    # the server's own rows (veneur.*: the previous flush's span, which
    # re-entered the pipeline) share the blocks of their groups; they
    # are told apart by name and counted on their own
    own = _own_rows(col)
    if len(col) - own != want_rows:
        raise AssertionError(f"{len(col) - own} rows of the traffic "
                             f"flushed, want {want_rows}")
    status = {m.name: (m.value, m.message) for m in col.extras
              if m.type.value == "status"}
    if len(status) != len(col.extras) or status != {
            f"ingest.check.{i}": (float(i % 4), f"m{i}")
            for i in range(checks)}:
        raise AssertionError("the extras differ from the service checks' "
                             "status rows")
    blocks = {}
    for blk in col.blocks:
        prefix = _traffic_prefix(blk)
        if prefix is not None:
            blocks[prefix] = blk
    if sorted(blocks) != ["ingest.c", "ingest.g", "ingest.h", "ingest.s"]:
        raise AssertionError(f"unexpected blocks {sorted(blocks)}")

    def by_index(blk, prefix):
        names = arena_strings(blk.names)
        mine = np.array([x.startswith(prefix + ".") for x in names])
        idx = np.array([int(x[len(prefix) + 1:])
                        for x, m in zip(names, mine) if m])
        vals = _block_matrix(blk)[mine, 0]
        out = np.full(len(idx), np.nan)
        out[idx] = vals
        return out, idx

    counters, _ = by_index(blocks["ingest.c"], "ingest.c")
    gauges, _ = by_index(blocks["ingest.g"], "ingest.g")
    if not (np.all(blocks["ingest.c"].type_codes == TYPE_COUNTER)
            and np.array_equal(counters, t["counters"])
            and np.array_equal(gauges, t["gauges"])):
        raise AssertionError("ingest.c/g differ from what was sent")
    hb = blocks["ingest.h"]
    sfx = [b".max", b".min", b".count"] + [
        f".{int(p * 100)}percentile".encode() for p in INGEST_PERCENTILES]
    if hb.suffixes != sfx:
        raise AssertionError(f"histogram suffixes {hb.suffixes}")
    mat = _block_matrix(hb)
    row_of = {name: r for r, name in enumerate(arena_strings(hb.names))}
    rng = np.random.default_rng(SEED + 7)
    pick = rng.choice(n, min(4096, n), replace=False)
    sel = mat[[row_of[f"ingest.h.{i}"] for i in pick]]
    samples = (t["q"][pick] / 8.0).astype(np.float32)
    mass = 8.0 * np.where(pick % 4 == 0, 2.0, 1.0)
    mass_err = float(np.max(np.abs(sel[:, 2] - mass) / mass))
    if not (np.array_equal(sel[:, 0], samples.max(1))
            and np.array_equal(sel[:, 1], samples.min(1))):
        raise AssertionError("ingest.h: min/max wrong")
    want = np.stack([_digest_reference(row, INGEST_PERCENTILES)
                     for row in samples])
    span = (samples.max(1) - samples.min(1)).astype(np.float64)
    worst = float(np.max(np.abs(sel[:, 3:] - want) / span[:, None]))
    if mass_err > 1e-6 or worst > 1e-3:
        raise AssertionError(f"histograms off: mass {mass_err:.3g}, "
                             f"percentiles {worst:.3g} of the span")
    est, _ = by_index(blocks["ingest.s"], "ingest.s")
    rel = np.abs(est - 16.0) / 16.0
    ref_err = 0.0
    for j in rng.choice(sets, min(512, sets), replace=False):
        hashes = np.array([hll_ops.hash_member(f"u{m}".encode())
                           for m in t["members"][j].tolist()], np.uint64)
        ref = _hll_reference(hashes, 14)
        ref_err = max(ref_err, abs(est[j] - ref) / ref)
    if ref_err > 1e-4:
        raise AssertionError(f"set estimates off the numpy HLL by "
                             f"{ref_err:.3g}")
    rec.update({"rows_flushed": len(col), "own_rows": own,
                "blocks": len(col.blocks),
                "hist_mass_rel_err": mass_err,
                "pct_err_vs_exact_digest": worst,
                "set_err_vs_numpy_hll": ref_err,
                "set_rel_err_max": float(rel.max())})


class _DatadogReceiver:
    """A stdlib HTTP server on 127.0.0.1 standing in for the Datadog API:
    it keeps every request body as received and answers 202.
    ``handle_max_s`` is the longest a request spent in its handler, from
    reading the body to the response: a POST slower than that on the
    client waited before the handler ran (connect, accept, the
    interpreter lock)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        bodies = self.bodies = []
        receiver = self
        self.handle_max_s = 0.0

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                t0 = time.perf_counter()
                body = self.rfile.read(int(self.headers["Content-Length"]))
                bodies.append((self.path.split("?", 1)[0], body,
                               self.headers.get("Content-Encoding")))
                self.send_response(202)
                self.send_header("Content-Length", "0")
                self.end_headers()
                receiver.handle_max_s = max(receiver.handle_max_s,
                                            time.perf_counter() - t0)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


class _Heartbeat:
    """A thread that wakes every 5 ms: ``max_gap`` is the longest it went
    between wakes since ``reset``, the longest no Python thread of the
    process could run (the interpreter lock held, a collector pause)."""

    def __init__(self):
        self.max_gap = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = time.perf_counter()
        while not self._stop.wait(0.005):
            now = time.perf_counter()
            self.max_gap = max(self.max_gap, now - last)
            last = now

    def reset(self):
        self.max_gap = 0.0

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


class _ColumnarRecorder:
    """A columnar metric sink that keeps each flush's ColumnarFlush and
    events; a per-row batch reaching it is a failure."""

    name = "record"

    def __init__(self):
        import queue

        self.flushes, self.events = queue.Queue(), queue.Queue()

    def start(self):
        pass

    def flush(self, metrics):
        raise AssertionError("per-row rows reached the columnar sink")

    def flush_columnar(self, batch):
        self.flushes.put(batch)

    def flush_other_samples(self, samples):
        self.events.put(list(samples))


def _flush_timers(store, dd) -> dict:
    """Busy seconds of each flush stage, summed over its threads: the
    flush thread's dispatch (every group's flush_begin) and fetch (each
    returned finish), the serializer lane's block building (the store's
    emission methods), the stream worker's serialize (the native
    serializer) and POST (each chunk body)."""
    from veneur_tpu_torch.core import store as store_mod

    acc = dict(dispatch_s=0.0, fetch_s=0.0, emit_s=0.0, serialize_s=0.0,
               post_s=0.0, post_max_s=0.0)
    lock = threading.Lock()

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    acc[key] += time.perf_counter() - t0
        return run

    def begin_timed(real):
        def begin(self, *args, **kwargs):
            return timed(timed(real, "dispatch_s")(self, *args, **kwargs),
                         "fetch_s")
        return begin

    classes = (store_mod.DigestGroup, store_mod.SetGroup,
               store_mod.HeavyHitterGroup)
    reals = [cls.flush_begin for cls in classes]
    for cls in classes:
        cls.flush_begin = begin_timed(cls.flush_begin)
    for name in ("_emit_digest_result", "_emit_set_result",
                 "_emit_topk_result", "_flush_scalars", "_flush_status"):
        setattr(store, name, timed(getattr(store, name), "emit_s"))
    real_serialize = dd._serialize_block
    acc["serialized"] = []

    def serialize(blk, timestamp):
        bodies = real_serialize(blk, timestamp)
        acc["serialized"].append((blk, len(bodies)))
        return bodies

    dd._serialize_block = timed(serialize, "serialize_s")
    real_post = dd._post_chunk_body

    def post(body, nrows):
        t0 = time.perf_counter()
        try:
            return real_post(body, nrows)
        finally:
            dt = time.perf_counter() - t0
            with lock:
                acc["post_s"] += dt
                acc["post_max_s"] = max(acc["post_max_s"], dt)

    dd._post_chunk_body = post

    def restore():
        for cls, real in zip(classes, reals):
            cls.flush_begin = real
    return acc, restore


def _check_bodies(recv, col, first_chunk, rec):
    """The receiver's series bodies of one flush: every body inflates,
    and their series count equals the blocks' rows; the first chunk's
    bodies (counters and gauges) parse back to their blocks exactly
    (names, types, values, the counters as rates). Empties the
    receiver."""
    from veneur_tpu_torch.core.columnar import TYPE_COUNTER, arena_strings

    series = [(raw, enc) for path, raw, enc in recv.bodies
              if path == "/api/v1/series"]
    recv.bodies.clear()
    if any(enc != "deflate" for _, enc in series):
        raise AssertionError("a series body was not deflated")
    n_first = sum(nbodies for _, nbodies in first_chunk)
    count = inflated = 0
    first = []
    for i, (raw, _) in enumerate(series):
        body = zlib.decompress(raw)
        count += body.count(b'{"metric":')
        inflated += len(body)
        if i < n_first:
            first.append(body)
    want = sum(len(b) for b in col.blocks)
    if count != want:
        raise AssertionError(f"the receiver got {count} series, the "
                             f"blocks hold {want}")
    k = 0
    for blk, nbodies in first_chunk:
        got = [s for body in first[k:k + nbodies]
               for s in json.loads(body)["series"]]
        k += nbodies
        names = arena_strings(blk.names)
        expect = [(names[r] + blk.suffixes[x].decode(),
                   "rate" if ty == TYPE_COUNTER else "gauge",
                   v / INGEST_INTERVAL_S if ty == TYPE_COUNTER else v)
                  for r, x, v, ty in zip(blk.rows.tolist(),
                                         blk.suffix_idx.tolist(),
                                         blk.values.tolist(),
                                         blk.type_codes.tolist())]
        if [(s["metric"], s["type"], s["points"][0][1]) for s in got] \
                != expect or any(s["host"] != "smoke" for s in got):
            raise AssertionError("a first-chunk body differs from its block")
    rec.update(bodies=len(series), series_posted=count,
               body_bytes_deflated=sum(len(raw) for raw, _ in series),
               body_bytes_inflated=inflated,
               first_chunk_series_parsed=sum(len(b) for b, _ in first_chunk))


def _ingest_window(fleet) -> int:
    """Datagrams in flight per window: at most INGEST_MAX_WINDOW, and
    no more than half the lanes' receive buffers at 4 KiB a datagram
    (a 1,432-byte datagram's kernel footprint is below that), so an
    uneven REUSEPORT spread still fits."""
    rcv = min(lane.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
              for lane in fleet.lanes)
    per = INGEST_SENDERS * INGEST_SOURCE_SOCKETS
    window = min(INGEST_MAX_WINDOW, fleet.num_lanes * rcv // (2 * 4096))
    return max(per, window // per * per)


def run_ingest_lanes(dev, rows: int, set_series: int, scalars: int,
                     raws: int, lanes: int, workdir):
    """A Server on ``dev`` whose UDP listener is the lane fleet takes the
    traffic twice (interval 1: every series first seen; interval 2: the
    same, after the flush bumped the epoch), each interval flushed in
    the default shape: columnar, pipelined and streaming, to a Datadog
    sink that POSTs to an in-process receiver and to a columnar
    recording sink. Returns (record, launch counts of the two
    intervals)."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

    t0 = time.perf_counter()
    t = _ingest_traffic(rows, set_series, scalars, raws)
    rec = {"histogram_series": rows, "set_series": set_series,
           "set_members": 16 * set_series, "counters": scalars,
           "gauges": scalars, "events": raws, "service_checks": raws,
           "lines": t["lines"], "datagrams": len(t["d_len"]),
           "datagram_bytes_max": int(t["d_len"].max()),
           "traffic_build_s": time.perf_counter() - t0}
    recv = _DatadogReceiver()
    cfg = Config(
        statsd_listen_addresses=["udp://127.0.0.1:0"], num_readers=lanes,
        interval=f"{INGEST_INTERVAL_S}s",
        percentiles=list(INGEST_PERCENTILES),
        aggregates=["min", "max", "count"], hostname="smoke",
        read_buffer_size_bytes=8 << 20, max_series=INGEST_MAX_SERIES)
    if not (cfg.flush_columnar and cfg.flush_streaming
            and cfg.flush_pipeline_depth == 2):
        raise AssertionError("the default flush shape changed")
    dd = DatadogMetricSink(
        interval=cfg.interval_seconds,
        flush_max_per_body=cfg.datadog_flush_max_per_body,
        hostname=cfg.hostname, tags=cfg.tags, dd_hostname=recv.url,
        api_key="smoke", requeue_max_bytes=cfg.sink_requeue_max_bytes)
    sink = _ColumnarRecorder()
    server = Server(cfg, metric_sinks=[dd, sink], device=dev)
    server.start()
    senders = restore = None
    # the interpreter's collector pauses every Python thread, the
    # in-process receiver's too: each pause of a flush, in seconds
    gc_pauses, gc_start = [], []

    def on_gc(phase, info):
        if phase == "start":
            gc_start[:] = [time.perf_counter()]
        elif gc_start:
            gc_pauses.append(time.perf_counter() - gc_start.pop())

    gc.callbacks.append(on_gc)
    beat = _Heartbeat()
    try:
        fleet = server.ingest_fleets[0]
        rec.update(lanes=fleet.num_lanes, listener=server.listeners[0][1],
                   using_native=server.using_native,
                   using_recvmmsg=server.using_recvmmsg,
                   rcvbuf=[lane.sock.getsockopt(socket.SOL_SOCKET,
                                                socket.SO_RCVBUF)
                           for lane in fleet.lanes])
        if not (rec["listener"] == "lanes" and fleet.num_lanes == lanes
                and rec["using_native"] and rec["using_recvmmsg"]):
            raise AssertionError(f"the lanes did not come up native with "
                                 f"recvmmsg: {rec}")
        acc = _instrument(server.store, fleet)
        stages, restore = _flush_timers(server.store, dd)
        rec["window"] = window = _ingest_window(fleet)
        senders = _PacedSenders(fleet.bound[0][1], t, workdir)
        _reset_counts(tc)
        rec["intervals"] = []
        for _ in range(2):
            r = _paced_interval(server, fleet, senders, t, window, acc)
            k1 = tc.drain_quantile.launches
            for key in stages:
                stages[key] = [] if key == "serialized" else 0.0
            chunks0, acked0 = dd.chunks_flushed, dd.chunk_rows_acked
            retries0 = dd.retries
            recv.bodies.clear()
            recv.handle_max_s = 0.0
            gc_pauses.clear()
            beat.reset()
            t1 = time.perf_counter()
            server.flush()
            r["flush_s"] = time.perf_counter() - t1
            r["python_gap_max_s"] = beat.max_gap
            r["receiver_max_s"] = recv.handle_max_s
            r["gc_pause_s"] = sum(gc_pauses)
            r["gc_pause_max_s"] = max(gc_pauses, default=0.0)
            r["k1_launches"] = tc.drain_quantile.launches - k1
            col = sink.flushes.get(timeout=60)
            r.update({k: v for k, v in stages.items() if k != "serialized"})
            r["emission_share"] = stages["emit_s"] / r["flush_s"]
            r["chunks"] = dd.chunks_flushed - chunks0
            r["chunk_rows_acked"] = dd.chunk_rows_acked - acked0
            r["post_retries"] = dd.retries - retries0
            if dd.chunk_rows_pending() or dd.chunk_rows_dropped \
                    or dd.flush_errors:
                raise AssertionError("the Datadog sink did not ack every "
                                     "chunk row")
            _check_ingest_flush(col, t, r)
            scalars_blocks = sum(1 for b in col.blocks
                                 if _traffic_prefix(b) in ("ingest.c",
                                                           "ingest.g"))
            _check_bodies(recv, col, stages["serialized"][:scalars_blocks],
                          r)
            del col
            stages["serialized"] = []
            events = sink.events.get(timeout=60)
            if [(e.name, e.message) for e in events] != [
                    ("title", "text")] * (t["raw_lines"] // 2):
                raise AssertionError("the interval's events did not reach "
                                     "flush_other_samples")
            rec["intervals"].append(r)
        counts = _counts(tc)
        # the flush's stage tree, the lanes' ingest.* stages and their
        # seal->merge latencies, as the timeline holds them
        rec["timeline"] = [_timeline_summary(e)
                           for e in server.obs_timeline.entries()]
    finally:
        gc.callbacks.remove(on_gc)
        beat.close()
        if restore is not None:
            restore()
        if senders is not None:
            senders.close()
        server.shutdown()
        recv.close()
    first = rec["intervals"][0]
    if first["k2_launches"] < 1 or any(r["k1_launches"] < 1
                                       for r in rec["intervals"]):
        raise AssertionError("want K2 >= 1 in interval 1 and K1 >= 1 a "
                             f"flush: {rec['intervals']}")
    return rec, counts


def _lane_twin(dev, t, columnar: bool = False):
    """The traffic through one lane (staged by hand, in order, 64
    datagrams a recv) into a store on ``dev`` that starts at full
    capacity, then one flush, per row (``flush_columnar: false``) or
    columnar. Returns (per-row emissions by key, or the ColumnarFlush;
    the flush's digest planes and percentiles on the host)."""
    from veneur_tpu_torch.core import store as store_mod
    from veneur_tpu_torch.ingest import IngestFleet
    from veneur_tpu_torch.protocol.addr import resolve_addr
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    store = store_mod.MetricStore(initial_capacity=t["rows"], device=dev)
    fleet = IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), 1,
                        1 << 20, 4096)
    try:
        lane = fleet.lanes[0]
        dgrams = _datagrams(t)
        for i in range(0, len(dgrams), 64):
            lane._stage_native(dgrams[i:i + 64])
        lane._seal()
        fleet.merge_sealed()
    finally:
        fleet.shutdown()
    captured = []
    real = store_mod._flush_digests

    def grab(*args):
        out = real(*args)
        captured.append(out)
        return out

    store_mod._flush_digests = grab
    try:
        final, _ = store.flush(list(INGEST_PERCENTILES),
                               HistogramAggregates.from_names(
                                   ["min", "max", "count"]), 0,
                               columnar=columnar)
    finally:
        store_mod._flush_digests = real
    n = t["rows"]
    digest, pcts = captured[0][:2]
    planes = [x[:n].cpu() for x in (digest.mean, digest.weight, digest.min,
                                    digest.max)] + [pcts[:n, :-1].cpu()]
    if columnar:
        return final, planes
    return {(m.name, tuple(m.tags)): m.value
            for m in final.to_intermetrics()}, planes


def _columnar_twin(dev, t, per_row: dict, workdir) -> dict:
    """The twin's traffic through a columnar flush on ``dev``, archived
    by the local-file plugin (the native TSV serializer); the TSV's rows
    must be the per-row twin's on the same device: the same (name, tags)
    keys, every value, percentiles too, within 1e-12 relative (the TSV
    writes the shortest decimal that round-trips; the counters pass
    through a rate and back)."""
    import csv
    import gzip

    from veneur_tpu_torch.plugins.localfile import LocalFilePlugin

    col, _ = _lane_twin(dev, t, columnar=True)
    path = Path(workdir) / "twin.tsv.gz"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    interval = 10
    LocalFilePlugin(str(path), "smoke", interval).flush_columnar(col)
    with gzip.open(path, "rt") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    got = {}
    for name, tags, mtype, *_, value, _part in rows:
        key = (name, tuple(tags[1:-1].split(",")) if tags != "{}" else ())
        got[key] = float(value) * (interval if mtype == "rate" else 1)
    if len(got) != len(rows) or set(got) != set(per_row):
        raise AssertionError("the columnar twin's TSV rows differ from the "
                             "per-row twin's keys")
    worst = 0.0
    for (name, tags), value in per_row.items():
        g = got[(name, tags)]
        rel = abs(g - value) / max(1.0, abs(value))
        if rel > 1e-12:
            raise AssertionError(f"columnar twin {name}: {g} != {value}")
        worst = max(worst, rel)
    path.unlink()
    return {"columnar_twin_rows": len(rows),
            "columnar_twin_blocks": len(col.blocks),
            "columnar_twin_rel_err": worst}


def ingest_twin(dev, rows: int = 4096, workdir=None):
    """A 4,096-series cut of the ingest traffic: through one lane into a
    CPU store and through process_metric into another CPU store, the
    emissions must be identical; through one lane on ``dev``, the merged
    digests must agree with the CPU lane's as the kernels agree with
    their plain versions. These twins flush per row (``flush_columnar:
    false``); a columnar twin on ``dev`` archives the same traffic
    through the local-file plugin (_columnar_twin). Returns the
    record."""
    import torch

    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.samplers import parser as p
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    workdir = workdir or Path(__file__).resolve().parent / "build" / "twin"
    t = _ingest_traffic(rows, 128, 64, 8)
    cpu_rows, cpu_planes = _lane_twin(torch.device("cpu"), t)
    by_line = MetricStore(initial_capacity=rows, device="cpu")
    for d in _datagrams(t):
        for line in p.split_lines(d):
            if not line.startswith((b"_e{", b"_sc")):
                by_line.process_metric(p.parse_metric(line))
    final, _ = by_line.flush(list(INGEST_PERCENTILES),
                             HistogramAggregates.from_names(
                                 ["min", "max", "count"]), 0)
    if {(m.name, tuple(m.tags)): m.value
            for m in final.to_intermetrics()} != cpu_rows:
        raise AssertionError("the lane and the per-line path emit "
                             "differently on the CPU")
    dev_rows, dev_planes = _lane_twin(dev, t)
    gm, gw, gmin, gmax, gp = dev_planes
    pm, pw, pmin, pmax, pp = cpu_planes
    if not (torch.equal(gmin, pmin) and torch.equal(gmax, pmax)):
        raise AssertionError("ingest twin extrema differ")
    err = _compare("ingest cpu twin", (gm, gw, gp), (pm, pw, pp), pw,
                   torch.zeros_like(pw), (pmax - pmin).float())
    return {"cpu_twin_rows": rows, "cpu_twin_emissions": len(cpu_rows),
            "cpu_twin_max_abs_err": err,
            **_columnar_twin(dev, t, dev_rows, workdir)}


def ingest_burst(dev, lanes: int, seconds: float = 5.0) -> dict:
    """Unpaced: two blast senders cycle 64 lines (one a datagram) over
    16 flows each against a fleet of ``lanes`` lanes on a store on
    ``dev``; after a warm-up that interns the series, packets/s over
    ``seconds``. Drops are reported, not failed on."""
    import os

    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.ingest import IngestFleet
    from veneur_tpu_torch.protocol.addr import resolve_addr

    store = MetricStore(initial_capacity=1 << 14, device=dev)
    fleet = IngestFleet(store, resolve_addr("udp://127.0.0.1:0"), lanes,
                        8 << 20, 4096)
    fleet.start()
    port = fleet.bound[0][1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _sender_code(), "blast", str(port),
         str(seconds + 60)], cwd=os.path.dirname(os.path.abspath(__file__)))
        for _ in range(INGEST_SENDERS)]
    rec = {"lanes": lanes}
    try:
        _wait_for(lambda: fleet.totals()["merged"] >= 4 * (1 << 14), 60,
                  "the burst to warm up")
        p0, d0 = fleet.totals()["packets"], _udp_drops(port)
        t0 = time.perf_counter()
        time.sleep(seconds)
        p1, d1 = fleet.totals()["packets"], _udp_drops(port)
        dt = time.perf_counter() - t0
        rec.update(packets_per_s=(p1 - p0) / dt, records_per_s=(p1 - p0) / dt,
                   kernel_drops_per_s=(d1 - d0) / dt)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
        fleet.shutdown()
    t = fleet.totals()
    rec.update(syscalls_per_packet=t["syscalls_per_packet"],
               shed_records=t["shed_records"],
               balance_ok=fleet.balance()["ok"])
    return rec


def lane_decode_rate(threads: int, seconds: float = 2.0) -> float:
    """Records/s through the native decode and columnar staging of
    ``threads`` lanes at once, each staging the burst's 64-line cycle in
    2,048-record spans (no sockets; sealed chunks are dropped): the
    lane's own ceiling behind the wire numbers, and how far the
    interpreter lock lets lanes overlap."""
    from veneur_tpu_torch.ingest import IngestLane

    lines = _burst_lines()
    span = [lines[i % 64] for i in range(2048)]
    socks, lanes, done = [], [], [0] * threads
    try:
        for i in range(threads):
            socks.append(socket.socket(socket.AF_INET, socket.SOCK_DGRAM))
            socks[-1].bind(("127.0.0.1", 0))
            lanes.append(IngestLane(i, socks[-1], 4096, 1 << 14,
                                    threading.Event()))
        if not all(lane.using_native for lane in lanes):
            raise AssertionError("the lanes did not load the native parser")

        def run(i):
            lane, end = lanes[i], time.perf_counter() + seconds
            while time.perf_counter() < end:
                lane._stage_native(span)
                lane.sealed.clear()
                done[i] += len(span)

        t0 = time.perf_counter()
        workers = [threading.Thread(target=run, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        return sum(done) / (time.perf_counter() - t0)
    finally:
        for sock in socks:
            sock.close()


def phase_ingest(dev, card: str, rows: int = INGEST_ROWS,
                 set_series: int = SET_SERIES, scalars: int = 4096,
                 raws: int = 256, lanes: int = 4):
    """The default UDP ingest lane at full width (run_ingest_lanes), the
    CPU twin (ingest_twin), the unpaced burst at 1 and 4 lanes and the
    lanes' decode-and-stage rate without sockets (lane_decode_rate).
    Returns the launch counts of the two paced intervals."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    workdir = Path(__file__).resolve().parent / "build" / "ingest_smoke"
    rec, counts = run_ingest_lanes(dev, rows, set_series, scalars, raws,
                                   lanes, workdir)
    rec["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(dev))
    rec["launches"] = counts
    rec.update(ingest_twin(dev, workdir=workdir))
    rec["burst"] = [ingest_burst(dev, n) for n in (1, lanes)]
    rec["lane_decode_records_per_s"] = {
        str(n): lane_decode_rate(n) for n in (1, lanes)}
    rec["phase_s"] = time.perf_counter() - t0
    timeline = rec.pop("timeline")
    emit({"phase": "ingest", "card": card, **rec})
    # the flush numbers alone, one line
    emit({"phase": "ingest_flush", "card": card, "intervals": [
        {k: r[k] for k in FLUSH_KEYS} for r in rec["intervals"]]})
    emit({"phase": "ingest_timeline", "card": card, "intervals": timeline})
    return counts


def _timeline_summary(entry: dict) -> dict:
    """One flush-timeline entry in brief: coverage, the stages two levels
    deep (ms), the lanes' ingest.* stages (lane-seconds) and the
    seal->merge latencies."""
    stages = {}
    for st in entry["stages"]:
        if st["name"].count(".") < 2 and not st["name"].startswith(
                "ingest"):
            stages[st["name"]] = stages.get(st["name"], 0.0) + \
                st["duration_ns"] / 1e6
    return {"interval": entry["interval"],
            "total_ms": entry["total_duration_ns"] / 1e6,
            "coverage_ratio": entry["coverage_ratio"],
            "overlap_ratio": entry.get("overlap_ratio"),
            "stages_ms": stages,
            "ingest_lane_s": {st["name"]: st["duration_ns"] / 1e9
                              for st in entry["stages"]
                              if st["name"].startswith("ingest")},
            "seal_to_merge": entry.get("ingest_seal_to_merge")}


# the ssf phase: SSF spans into a Server on the card

SSF_SERIES = 1 << 17             # histogram series carried in spans
#                                  (262,144 until the lifecycle phase)
SSF_SPAN_SAMPLES = 16            # samples a span
SSF_SERVICES = 64                # indicator spans: 64 services x {error, ok}
SSF_SCALARS = 4096               # counters, gauges and sets (16 members)
SSF_STATUS = 1024                # STATUS samples (the C++ slow lane)
SSF_RAWS = 256                   # events and service checks over statsd
SSF_TIMER = "ssf.indicator"


def _vint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """One length-delimited protobuf field."""
    return bytes([field << 3 | 2]) + _vint(len(payload)) + payload


def _tag_entries(tags) -> bytes:
    """SSFSample.tags (field 8) entries for (key, value) pairs."""
    return b"".join(_ld(8, _ld(1, k.encode()) + _ld(2, v.encode()))
                    for k, v in tags)


def _sample_heads(names, tags_of, rates, metric: int):
    """Per-series (head, tail) of an embedded SSFSample (span field 10):
    head + the float32 value's 4 bytes + tail is the whole field."""
    heads, tails = [], []
    for i, name in enumerate(names):
        nb = name.encode()
        pre = (b"\x08" + _vint(metric) + _ld(2, nb) + b"\x1d")
        post = ((b"\x3d" + np.float32(rates[i]).tobytes()
                 if rates[i] != 1.0 else b"") + _tag_entries(tags_of(i)))
        body = len(pre) + 4 + len(post)
        heads.append(b"\x52" + _vint(body) + pre)
        tails.append(post)
    return heads, tails


def _ssf_traffic(series: int, scalars: int, status: int, raws: int):
    """The ssf phase's traffic, from the seed.

    ``series`` histogram series with 2 tags and 8 samples each (units of
    1/8, exact in float32; a quarter of the series at rate 0.5), 16
    samples a span: as in the ingest phase, every series' first four
    samples travel first (four series a span) and the last four, shifted
    +1000, after everything else, so the shift guard drains through K2.
    Between them: spans of ``scalars`` counters (every 8th at rate 0.1),
    gauges, sets of 16 members, and ``status`` STATUS samples. Every span
    is an indicator span: service svc<j % 64>, error on odd j // 64, a
    duration of 10^U(3, 10) ns. Over statsd: ``raws`` events (every
    vdogstatsd_* section) and service checks."""
    from veneur_tpu_torch.protocol import ssf

    gens = iter([np.random.default_rng(s) for s in
                 np.random.SeedSequence(SEED + 8).spawn(6)])
    q = np.concatenate(
        [np.round(next(gens).gamma(2.0, 10.0, (series, 4)) * 8),
         np.round((1000.0 + next(gens).gamma(2.0, 10.0, (series, 4))) * 8)],
        axis=1).astype(np.int64)
    members = next(gens).integers(0, 1 << 48, (scalars, 16))
    cvals = next(gens).integers(1, 1000, scalars)
    gvals = np.round(next(gens).normal(0.0, 1000.0, scalars), 3)
    rates = np.where(np.arange(series) % 4 == 0, 0.5, 1.0)
    heads, tails = _sample_heads(
        [f"ssf.h.{i}" for i in range(series)],
        lambda i: (("az", f"z{i % 4}"), ("svc", f"s{i % 64}")), rates, 2)
    vbytes = (q / 8.0).astype("<f4").tobytes()
    hist = [heads[i] + vbytes[4 * (8 * i + k):4 * (8 * i + k) + 4]
            + tails[i] for i in range(series) for k in range(8)]
    first = [hist[8 * i + k] for i in range(series) for k in range(4)]
    last = [hist[8 * i + k] for i in range(series) for k in range(4, 8)]
    del hist, heads, tails
    c_rates = np.where(np.arange(scalars) % 8 == 0, 0.1, 1.0)
    ch, ct = _sample_heads([f"ssf.c.{i}" for i in range(scalars)],
                           lambda i: (), c_rates, 0)
    cb = cvals.astype("<f4").tobytes()
    middle = [ch[i] + cb[4 * i:4 * i + 4] + ct[i] for i in range(scalars)]
    gh, gt = _sample_heads([f"ssf.g.{i}" for i in range(scalars)],
                           lambda i: (), np.ones(scalars), 1)
    gb = gvals.astype("<f4").tobytes()
    middle += [gh[i] + gb[4 * i:4 * i + 4] + gt[i] for i in range(scalars)]
    middle += [_ld(10, b"\x08\x03" + _ld(2, f"ssf.s.{i}".encode())
                   + _ld(5, f"u{m}".encode()))
               for i, ms in enumerate(members.tolist()) for m in ms]
    middle += [_ld(10, ssf.encode_sample(ssf.SSFSample(
        metric=ssf.SSFSample.STATUS, name=f"ssf.st.{i}", status=i % 4,
        message=f"st{i}", tags={"role": "db"}))) for i in range(status)]
    samples = first + middle + last
    n_spans = -(-len(samples) // SSF_SPAN_SAMPLES)
    durs = np.floor(10.0 ** next(gens).uniform(3.0, 10.0, n_spans)) \
        .astype(np.int64)
    base = 1_700_000_000_000_000_000
    datagrams = []
    for j in range(n_spans):
        head = ssf.encode_span(ssf.SSFSpan(
            trace_id=j + 1, id=j + 1, start_timestamp=base + j,
            end_timestamp=base + j + int(durs[j]),
            error=bool((j // SSF_SERVICES) % 2),
            service=f"svc{j % SSF_SERVICES}", indicator=True, name="op"))
        datagrams.append(head + b"".join(
            samples[j * SSF_SPAN_SAMPLES:(j + 1) * SSF_SPAN_SAMPLES]))
    del samples, first, last, middle
    lens = np.fromiter(map(len, datagrams), np.int64, len(datagrams))
    blob = b"".join(datagrams)
    del datagrams
    d_off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    events = [f"_e{{{len(f'title{i}')},{len(f'text {i}')}}}:title{i}|"
              f"text {i}|h:host{i % 8}|k:agg{i}|p:low|s:src|t:info|#k:v"
              for i in range(raws)]
    checks = [f"_sc|ssf.check.{i}|{i % 4}|h:host{i % 8}|#k:v|m:msg {i}"
              for i in range(raws)]
    raw_lines = [ln.encode() for pair in zip(events, checks) for ln in pair]
    mult = int(np.float32(1.0) / np.float32(0.1))
    return {"blob": blob, "d_off": d_off, "d_len": lens, "q": q,
            "members": members, "durs": durs,
            "counters": cvals * np.where(c_rates == 0.1, mult, 1),
            "gauges": gvals.astype(np.float32).astype(np.float64),
            "raw_lines": raw_lines, "rows": series, "scalars": scalars,
            "status": status, "raws": raws, "spans": n_spans,
            "samples": 8 * series + 2 * scalars + 16 * scalars + status}


def _ssf_datagrams(t) -> list:
    blob = t["blob"]
    return [blob[o:o + n] for o, n in zip(t["d_off"].tolist(),
                                           t["d_len"].tolist())]


def _check_ssf_codec(t) -> None:
    """The traffic's bytes decode, with the port's codec, to what was
    meant: the first and last span, sample for sample."""
    from veneur_tpu_torch.protocol import ssf

    dgrams = _ssf_datagrams(t)
    for j in (0, len(dgrams) - 1):
        span = ssf.decode_span(dgrams[j])
        if not (span.indicator and span.id == j + 1
                and span.end_timestamp - span.start_timestamp
                == int(t["durs"][j])
                and len(span.metrics) == SSF_SPAN_SAMPLES):
            raise AssertionError(f"span {j} decodes wrong: {span}")
        s = span.metrics[0]
        # the j-th span's first sample: a first half, or a last half
        p = j * SSF_SPAN_SAMPLES - (len(dgrams) * SSF_SPAN_SAMPLES
                                    - 4 * t["rows"])
        i, k = (j * 4, 0) if p < 0 else (p // 4, 4)
        if (s.name, s.value, s.tags) != (
                f"ssf.h.{i}", t["q"][i, k] / 8.0,
                {"az": f"z{i % 4}", "svc": f"s{i % 64}"}):
            raise AssertionError(f"span {j}'s first sample: {s}")


def _ssf_server(dev, sock_path, sinks, native: bool = True):
    """A Server on ``dev`` as the ssf phase runs it: a udp:// SSF listener
    (the native pool, or Python readers with ``native=False``), a
    unix:// one at ``sock_path`` if given, 4 readers or lanes, the
    indicator timer, and ``sinks`` = (metric sink, span sink). A stream
    arrives unpaced, one span a channel item, so the span channel holds
    4,096 items: the default 100 sheds when the span worker falls behind
    the stream's reader."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server

    addrs = ["udp://127.0.0.1:0"] + ([f"unix://{sock_path}"] if sock_path
                                     else [])
    return Server(Config(
        statsd_listen_addresses=["udp://127.0.0.1:0"], num_readers=4,
        ssf_listen_addresses=addrs, native_ingest=native,
        span_channel_capacity=4096,
        indicator_span_timer_name=SSF_TIMER, interval="86400s",
        percentiles=list(INGEST_PERCENTILES),
        aggregates=["min", "max", "count"], hostname="smoke",
        read_buffer_size_bytes=8 << 20),
        metric_sinks=[sinks[0]], span_sinks=[sinks[1]], device=dev)


def _ssf_instrument(server) -> dict:
    """Counters and time around the native pump's three steps, from the
    pump's thread: records into process_batch, slow-lane samples, spans
    handed to the span workers."""
    acc = {"records": 0, "batches": 0, "slow": 0, "spans": 0,
           "process_batch_s": 0.0}
    store = server.store
    real_batch, real_slow = store.process_batch, server._slow_ssf_sample
    real_spans = server.handle_ssf_batch

    def process_batch(batch):
        t0 = time.perf_counter()
        try:
            return real_batch(batch)
        finally:
            acc["process_batch_s"] += time.perf_counter() - t0
            acc["records"] += int(batch.count)
            acc["batches"] += 1

    def slow(raw):
        acc["slow"] += 1
        real_slow(raw)

    def spans(batch):
        acc["spans"] += len(batch)
        real_spans(batch)

    store.process_batch = process_batch
    server._slow_ssf_sample = slow
    server.handle_ssf_batch = spans
    return acc


def _emission_timer(store) -> dict:
    """Wall time of the flush's per-row emission methods."""
    acc = {"emit_s": 0.0}
    for name in ("_emit_digest_result", "_emit_set_result",
                 "_emit_topk_result", "_flush_scalars", "_flush_status"):
        real = getattr(store, name)

        def timed(*args, _real=real, **kwargs):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                acc["emit_s"] += time.perf_counter() - t0
        setattr(store, name, timed)
    return acc


def _check_ssf_flush(rows, events, t, rec) -> None:
    """The flushed rows and events against the traffic: the row count;
    on 4,096 seeded histogram series count (the sum of 1/rate), min and
    max exact and percentiles within 0.02 x span of the exact digest;
    every indicator timer's count equal to its spans, its extrema the
    durations (doubles on the C++ lane) as the float32 digest holds them,
    its percentiles inside the extrema and in order (their rank error is
    reported: on durations spread over seven decades the dense store's
    bins are ~3.4% off in rank, in the JAX package as here; the twin
    holds the card to the CPU); counters and gauges exact; set
    estimates within 1e-4 of a numpy HLL; status rows' value, message and
    hostname; the events' vdogstatsd_* tags."""
    from veneur_tpu_torch.ops import hll as hll_ops

    n, sc, st, raws = t["rows"], t["scalars"], t["status"], t["raws"]
    timers = 2 * SSF_SERVICES
    want_rows = ((n + timers) * (3 + len(INGEST_PERCENTILES)) + 3 * sc
                 + st + raws)
    if len(rows) != want_rows:
        raise AssertionError(f"{len(rows)} rows flushed, want {want_rows}")
    sfx = ["count", "min", "max"] + [f"{int(p * 100)}percentile"
                                     for p in INGEST_PERCENTILES]
    rng = np.random.default_rng(SEED + 9)
    pick = rng.choice(n, min(4096, n), replace=False)
    by = {}
    for m in rows:
        by[(m.name, tuple(m.tags))] = m
    worst = mass_err = 0.0
    for i in pick:
        tags = ("az:z%d" % (i % 4), "svc:s%d" % (i % 64))
        samples = (t["q"][i] / 8.0).astype(np.float32)
        mass = 8.0 * (2.0 if i % 4 == 0 else 1.0)
        got = {s: by[(f"ssf.h.{i}.{s}", tags)].value for s in sfx}
        mass_err = max(mass_err, abs(got["count"] - mass) / mass)
        if got["min"] != samples.min() or got["max"] != samples.max():
            raise AssertionError(f"ssf.h.{i}: min/max wrong")
        want = _digest_reference(samples, INGEST_PERCENTILES)
        span = float(samples.max() - samples.min())
        worst = max(worst, float(np.max(np.abs(
            np.array([got[s] for s in sfx[3:]]) - want))) / span)
    j = np.arange(t["spans"])
    timer_err = timer_rank_err = 0.0
    for svc in range(SSF_SERVICES):
        for err in (0, 1):
            sel = (j % SSF_SERVICES == svc) & ((j // SSF_SERVICES) % 2
                                               == err)
            durs = t["durs"][sel].astype(np.float64).astype(np.float32)
            tags = ("error:%s" % ("true" if err else "false"),
                    f"service:svc{svc}")
            got = {s: by[(f"{SSF_TIMER}.{s}", tags)].value for s in sfx}
            if (got["count"] != sel.sum() or got["min"] != durs.min()
                    or got["max"] != durs.max()):
                raise AssertionError(f"indicator timer {tags}: {got}")
            want = _digest_reference(durs, INGEST_PERCENTILES)
            vals = np.array([got[s] for s in sfx[3:]])
            if not (durs.min() <= vals.min() and vals.max() <= durs.max()
                    and np.all(np.diff(vals) >= 0)):
                raise AssertionError(f"indicator timer {tags}: percentiles "
                                     f"{vals} out of order or range")
            timer_err = max(timer_err, float(np.max(np.abs(vals - want)))
                            / float(durs.max() - durs.min()))
            # a value's quantile range under the midpoint convention
            # (sample k sits at (k + 0.5) / n): from below its lowest
            # sample-rank to above its highest
            x = np.sort(durs.astype(np.float64))
            n_x = len(x)
            for q, v in zip(INGEST_PERCENTILES, vals):
                lo = (np.searchsorted(x, v, "left") - 0.5) / n_x
                hi = (np.searchsorted(x, v, "right") + 0.5) / n_x
                timer_rank_err = max(timer_rank_err,
                                     max(lo - q, q - hi, 0.0))
    if mass_err > 1e-6 or worst > 0.02:
        raise AssertionError(f"digests off: mass {mass_err:.3g}, "
                             f"percentiles {worst:.3g} of the span")
    for i in range(sc):
        if by[(f"ssf.c.{i}", ())].value != t["counters"][i] \
                or by[(f"ssf.g.{i}", ())].value != t["gauges"][i]:
            raise AssertionError(f"ssf.c/g.{i} differ from what was sent")
    ref_err = 0.0
    for i in rng.choice(sc, min(512, sc), replace=False):
        hashes = np.array([hll_ops.hash_member(f"u{m}".encode())
                           for m in t["members"][i].tolist()], np.uint64)
        ref = _hll_reference(hashes, 14)
        ref_err = max(ref_err, abs(by[(f"ssf.s.{i}", ())].value - ref) / ref)
    if ref_err > 1e-4:
        raise AssertionError(f"set estimates off the numpy HLL by "
                             f"{ref_err:.3g}")
    for i in range(st):
        m = by[(f"ssf.st.{i}", ("role:db",))]
        # the reference's parseMetricSSF carries a STATUS sample's status,
        # not its message
        if (m.type.value, m.value, m.message, m.hostname) != (
                "status", float(i % 4), "", ""):
            raise AssertionError(f"status row ssf.st.{i}: {m}")
    for i in range(raws):
        m = by[(f"ssf.check.{i}", ("k:v",))]
        if (m.type.value, m.value, m.message, m.hostname) != (
                "status", float(i % 4), f"msg {i}", f"host{i % 8}"):
            raise AssertionError(f"service check row {i}: {m}")
    got_events = sorted((e.name, e.message, tuple(sorted(e.tags.items())))
                        for e in events)
    want_events = sorted(
        (f"title{i}", f"text {i}", tuple(sorted({
            "vdogstatsd_ev": "", "vdogstatsd_hostname": f"host{i % 8}",
            "vdogstatsd_ak": f"agg{i}", "vdogstatsd_pri": "low",
            "vdogstatsd_st": "src", "vdogstatsd_at": "info",
            "k": "v"}.items()))) for i in range(raws))
    if got_events != want_events:
        raise AssertionError("the events in flush_other_samples differ "
                             "from what was sent")
    rec.update({"rows_flushed": len(rows), "hist_mass_rel_err": mass_err,
                "pct_err_vs_exact_digest": worst,
                "timer_pct_err_vs_exact_digest": timer_err,
                "timer_pct_rank_err": timer_rank_err,
                "set_err_vs_numpy_hll": ref_err, "events": len(events)})


def _wait_ssf_window(server, reader, acc, p0, sent, timeout=300):
    """Until the pool received ``sent`` datagrams and the pump handed
    them all on (decoded, or counted as decode errors or drops)."""
    _wait_for(lambda: reader.packets() - p0 >= sent
              and acc["spans"] + server.packet_errors
              + server.native_ssf_drops >= sent,
              timeout, "the SSF pump to catch up with a window")


def _traffic_spans(span_sink) -> int:
    """Spans a channel span sink got, but the server's own: the flush's
    root span ("flush") and its stages' ("veneur.flush.*")."""
    return sum(1 for s in list(span_sink.queue.queue)
               if not (s.name == "flush" or s.name.startswith("veneur.")))


def run_ssf(dev, t, workdir, sock_path):
    """The ssf phase's main path: a Server on ``dev`` with the native SSF
    reader pool (4 readers) and a unix:// SSF listener takes the traffic
    in paced windows from the sender processes, and the event and
    service-check lines over its statsd listener; one flush through K1.
    Returns (record, launch counts)."""
    import torch

    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.sinks.channel import (ChannelMetricSink,
                                                ChannelSpanSink)

    sink, span_sink = ChannelMetricSink(), ChannelSpanSink()
    server = _ssf_server(dev, sock_path, (sink, span_sink))
    server.start()
    senders = None
    try:
        rungs = [r for _, r, _ in server.ssf_listeners]
        reader = server.native_ssf_readers[0] \
            if server.native_ssf_readers else None
        if rungs != ["native", "stream"] or reader is None:
            raise AssertionError(f"the SSF listeners came up as {rungs}")
        acc = _ssf_instrument(server)
        emit_acc = _emission_timer(server.store)
        window = _ingest_window(server.ingest_fleets[0])
        port = reader.port
        senders = _PacedSenders(port, t, workdir)
        # earlier phases' stores die in reference cycles: collect them,
        # so the peak is this phase's own
        gc.collect()
        mem0 = int(torch.cuda.memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts(tc)
        t0 = time.perf_counter()
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            lines = t["raw_lines"]
            for i in range(0, len(lines), 16):
                tx.sendto(b"\n".join(lines[i:i + 16]),
                          server.statsd_addrs[0])
        p0, sent = reader.packets(), 0
        per_sender = window // INGEST_SENDERS
        for a in range(0, max(senders.counts), per_sender):
            sent += senders.send(a, a + per_sender)
            _wait_ssf_window(server, reader, acc, p0, sent)
        want_processed = t["samples"] + t["spans"] + t["raws"]
        # shed spans never arrive: stop waiting, the check below fails
        _wait_for(lambda: server.spans_dropped
                  or server.overload.shed_total() or (
            server.store.processed >= want_processed
            and span_sink.queue.qsize() >= t["spans"]
            and len(server.event_worker) >= t["raws"]), 600,
            "every span to reach the span sinks and every sample the "
            "store")
        wall = time.perf_counter() - t0
        k2 = tc.compress_presorted.launches
        processed = server.store.processed
        spilled = _spilled(server.store)
        t1 = time.perf_counter()
        server.flush()
        flush_s = time.perf_counter() - t1
        counts = _counts(tc)
        rows = sink.get_flush(timeout=60)
        events = sink.get_other_samples(timeout=60)
        mem = int(torch.cuda.max_memory_allocated(dev))
    finally:
        if senders is not None:
            senders.close()
        server.shutdown()
    drops = _udp_drops(port)
    samples = t["samples"] + t["spans"]
    rec = {"histogram_series": t["rows"], "spans": t["spans"],
           "samples": t["samples"], "indicator_timers": t["spans"],
           "datagrams_sent": sent,
           "datagram_bytes_max": int(t["d_len"].max()), "window": window,
           "ingest_s": wall, "spans_per_s": t["spans"] / wall,
           "samples_per_s": samples / wall,
           "records_native": acc["records"], "slow_lane": acc["slow"],
           "pump_batches": acc["batches"],
           "process_batch_s": acc["process_batch_s"],
           "spans_to_sinks": _traffic_spans(span_sink),
           "own_spans": span_sink.queue.qsize() - _traffic_spans(span_sink),
           "spans_dropped": server.spans_dropped,
           "native_ssf_drops": server.native_ssf_drops,
           "decode_errors_and_invalid": server.packet_errors,
           "quarantined": server.quarantined,
           "overload": server.overload.snapshot(),
           "spilled": spilled,
           "kernel_drops_total": drops, "processed": processed,
           "flush_s": flush_s, "emit_s": emit_acc["emit_s"],
           "emission_share": emit_acc["emit_s"] / flush_s,
           "k2_before_flush": k2, "memory_allocated_before": mem0,
           "max_memory_allocated": mem,
           "launches": counts}
    # exact conservation on the native lane: every span received; every
    # sample and timer a record or a slow-lane sample, all merged
    if not (sent == len(t["d_len"]) and drops == 0
            and rec["spans_to_sinks"] == t["spans"]
            and rec["spans_dropped"] == rec["native_ssf_drops"] == 0
            and rec["decode_errors_and_invalid"] == 0
            and rec["quarantined"] == rec["spilled"] == 0
            and rec["overload"]["shed"] == {"statsd": 0, "ssf": 0,
                                            "spans": 0}
            and acc["records"] + acc["slow"] == samples
            and acc["slow"] == t["status"]
            and processed == samples + t["raws"]):
        raise AssertionError(f"the SSF lane did not conserve the traffic: "
                             f"{rec}")
    if counts["compress_presorted.launches"] < 1 \
            or counts["drain_quantile.launches"] != 1:
        raise AssertionError(f"want K2 >= 1 and K1 = 1: {counts}")
    _check_ssf_flush(rows, events, t, rec)
    return rec, counts


def _ssf_rows(dev, t, way: str):
    """One Server on ``dev`` takes the traffic one way: "python" (UDP,
    native_ingest off), "unix" (framed spans over a UNIX socket) or
    "native" (the C++ pool); rows by (name, tags, type) after one
    flush."""
    import tempfile

    from veneur_tpu_torch.protocol import wire
    from veneur_tpu_torch.sinks.channel import (ChannelMetricSink,
                                                ChannelSpanSink)

    sock_dir = tempfile.mkdtemp(prefix="vssf")
    sock_path = f"{sock_dir}/ssf.sock"
    sink, span_sink = ChannelMetricSink(), ChannelSpanSink()
    server = _ssf_server(dev, sock_path if way == "unix" else None,
                         (sink, span_sink), native=way == "native")
    # the group starts at full size: a group that grows drains its
    # staging first, at a point that differs between the paths
    server.store.histograms.ensure_capacity(t["rows"] + 2 * SSF_SERVICES)
    server.start()
    try:
        dgrams = _ssf_datagrams(t)
        if way == "unix":
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as tx:
                tx.connect(sock_path)
                tx.sendall(b"".join(wire.FRAME_HEADER.pack(0, len(d)) + d
                                    for d in dgrams))
        else:
            # at most 64 datagrams in flight: a small default receive
            # buffer holds them
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
                for i, d in enumerate(dgrams):
                    tx.sendto(d, server.ssf_addrs[0])
                    if i % 32 == 31:
                        _wait_for(lambda: span_sink.queue.qsize()
                                  >= i + 1 - 64, 120, "the span sink")
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(b"\n".join(t["raw_lines"]), server.statsd_addrs[0])
        want = t["samples"] + t["spans"] + t["raws"]
        _wait_for(lambda: server.spans_dropped or (
            server.store.processed >= want
            and span_sink.queue.qsize() >= t["spans"]), 300,
            f"the {way} twin")
        if server.spans_dropped:
            raise AssertionError(f"the {way} twin shed "
                                 f"{server.spans_dropped} spans")
        server.flush()
        rows = sink.get_flush(timeout=60)
    finally:
        server.shutdown()
        Path(sock_path).unlink(missing_ok=True)
        Path(sock_dir).rmdir()
    return {(m.name, tuple(m.tags), m.type.value): (m.value, m.message,
                                                    m.hostname)
            for m in rows}


def ssf_twin(dev, rows: int = 4096) -> dict:
    """A 4,096-series cut of the ssf traffic three ways on the CPU (the
    Python UDP rung, framed over a UNIX socket, the native lane): the
    rows must be identical (the indicator timer is a float32 on the
    first two and a double on the third, but the digest stages float32,
    so the rows agree). Then the native lane and the UNIX stream on
    ``dev``: non-percentile rows exact, percentiles within 1e-4 x
    (max - min) of the CPU's, as the kernels agree with their plain
    versions. Returns the record."""
    import torch

    t = _ssf_traffic(rows, 64, 16, 8)
    cpu = torch.device("cpu")
    ways = {w: _ssf_rows(cpu, t, w) for w in ("python", "unix", "native")}
    if not ways["python"] == ways["unix"] == ways["native"]:
        raise AssertionError("the SSF rungs emit differently on the CPU")
    want = ways["native"]
    err = 0.0
    for way in ("native", "unix"):
        got = _ssf_rows(dev, t, way)
        if set(got) != set(want):
            raise AssertionError(f"the {way} twin on the card emits other "
                                 "rows")
        for key, (v, msg, host) in want.items():
            gv, gmsg, ghost = got[key]
            name = key[0]
            if not name.endswith("percentile"):
                if (gv, gmsg, ghost) != (v, msg, host):
                    raise AssertionError(f"{way} twin: {key} {got[key]} "
                                         f"vs {want[key]}")
                continue
            base = name.rsplit(".", 1)[0]
            lo = want[(f"{base}.min", key[1], "gauge")][0]
            hi = want[(f"{base}.max", key[1], "gauge")][0]
            err = max(err, abs(gv - v) / max(hi - lo, 1e-30))
    if err > 1e-4:
        raise AssertionError(f"SSF twin percentiles off by {err:.3g} of "
                             "the span")
    return {"cpu_twin_rows": rows, "cpu_twin_spans": t["spans"],
            "cpu_twin_emissions": len(want),
            "cuda_twin_pct_err_of_span": err}


def phase_ssf(dev, card: str) -> dict:
    """SSF at full width (run_ssf), then the 4,096-series twin
    (ssf_twin). Returns the launch counts of the main path."""
    import tempfile

    t0 = time.perf_counter()
    t = _ssf_traffic(SSF_SERIES, SSF_SCALARS, SSF_STATUS, SSF_RAWS)
    rec = {"traffic_build_s": time.perf_counter() - t0}
    _check_ssf_codec(t)
    workdir = Path(__file__).resolve().parent / "build" / "ssf_smoke"
    sock_dir = Path(tempfile.mkdtemp(prefix="vssf"))
    try:
        run, counts = run_ssf(dev, t, workdir, str(sock_dir / "ssf.sock"))
    finally:
        (sock_dir / "ssf.sock").unlink(missing_ok=True)
        sock_dir.rmdir()
    rec.update(run)
    del t
    rec.update(ssf_twin(dev))
    rec["phase_s"] = time.perf_counter() - t0
    emit({"phase": "ssf", "card": card, **rec})
    return counts


# the heavy_hitters phase: veneurtopk sets through the port on the card

HH_SERIES = 1 << 14              # veneurtopk set series (65,536 until
                                 # the fleet_ha phase came)
HH_KEYS = 1 << 16                # the members' universe, drawn Zipf(1.1)
HH_ZIPF_S = 1.1
HH_SAMPLES = 1 << 19             # top-k samples: 32 a series
HH_HIST_SERIES = 1 << 14         # histogram series beside them, 8 samples
HH_EVICT_SERIES = 256            # the eviction subphase: 4,096 samples
HH_EVICT_SAMPLES = 1 << 20       # a series, so every top-k list evicts
HH_FWD_SERIES = 4096             # the forward subphase's series a local
HH_FWD_KEYS = 6                  # its keys a series, 4-27 samples each


def _hh_traffic():
    """The heavy_hitters phase's traffic, from the seed: HH_SERIES top-k
    set series of 32 samples each, members drawn Zipf(1.1) over HH_KEYS
    keys, in a shuffled order; series i % 8 == 6 go to the second
    Server's C++ pool, i % 8 == 7 to its SSF stream, the rest (three
    quarters) to the first Server's lanes, between the two halves of
    HH_HIST_SERIES histogram series (4 samples from gamma(2, 10) in
    units of 1/8, then 4 shifted +1000, a quarter of the series at
    @0.5, as in the ingest phase, so the shift guard drains through
    K2)."""
    gens = iter([np.random.default_rng(s) for s in
                 np.random.SeedSequence(SEED + 10).spawn(3)])
    w = 1.0 / np.arange(1, HH_KEYS + 1) ** HH_ZIPF_S
    keys = next(gens).choice(HH_KEYS, HH_SAMPLES, p=w / w.sum())
    owner = np.repeat(np.arange(HH_SERIES), HH_SAMPLES // HH_SERIES)
    order = next(gens).permutation(HH_SAMPLES)
    keys, owner = keys[order], owner[order]
    route = np.where(owner % 8 == 6, 1, np.where(owner % 8 == 7, 2, 0))
    g = next(gens)
    q = np.concatenate(
        [np.round(g.gamma(2.0, 10.0, (HH_HIST_SERIES, 4)) * 8),
         np.round((1000.0 + g.gamma(2.0, 10.0, (HH_HIST_SERIES, 4))) * 8)],
        axis=1) / 8.0
    # a series' four samples travel together: the guard looks for a row
    # whose chunk mass steps off its accumulated bins
    hist = [[f"hh.h.{i}:{v!r}|h{'|@0.5' if i % 4 == 0 else ''}"
             for v in vs] for i, vs in enumerate(q.tolist())]
    first = [ln for h in hist for ln in h[:4]]
    last = [ln for h in hist for ln in h[4:]]
    sel = route == 0
    lanes = first + [f"hh.t.{o}:k{m}|s|#veneurtopk" for o, m in zip(
        owner[sel].tolist(), keys[sel].tolist())] + last
    sel = route == 1
    pool = [f"hh.t.{o}:k{m}|s|#veneurtopk" for o, m in zip(
        owner[sel].tolist(), keys[sel].tolist())]
    sel = route == 2
    return {"lanes": _pack_lines(lanes), "pool": _pack_lines(pool),
            "ssf": (owner[sel], keys[sel]), "owner": owner, "keys": keys,
            "route": route, "q": q}


def _hh_spans(owner, keys, per: int = 16) -> list:
    """Framed SSF spans of ``per`` SET samples each (name hh.t.<series>,
    member k<key>, tag veneurtopk), for a UNIX stream listener."""
    from veneur_tpu_torch.protocol import ssf, wire

    tag = _tag_entries((("veneurtopk", ""),))
    samples = [_ld(10, b"\x08\x03" + _ld(2, f"hh.t.{o}".encode())
                   + _ld(5, f"k{m}".encode()) + tag)
               for o, m in zip(owner.tolist(), keys.tolist())]
    frames = []
    for j in range(0, len(samples), per):
        body = ssf.encode_span(ssf.SSFSpan(
            trace_id=j + 1, id=j + 1, start_timestamp=1, end_timestamp=2,
            service="hh", name="op")) + b"".join(samples[j:j + per])
        frames.append(wire.FRAME_HEADER.pack(0, len(body)) + body)
    return frames


def _hh_exact(owner, keys) -> dict:
    """Exact per-(series, key) counts as sorted codes and counts."""
    codes, counts = np.unique(owner.astype(np.int64) * HH_KEYS + keys,
                              return_counts=True)
    return {"codes": codes, "counts": counts, "total": len(owner)}


def _check_topk(rows, exact, k: int, depth: int, width: int,
                prefix: str = "hh.t.") -> dict:
    """One Server's emitted ``.topk`` rows against the exact counts of
    what it was sent: no hex member (every member name comes back);
    every estimate >= its exact count (count-min never undercounts);
    at most a share e^-depth of them past exact + e/w * N (the
    count-min guarantee, N the samples into the shared table); every
    key whose exact count exceeds its series' K-th exact count by e/w *
    N present. Returns the record."""
    series, members, est = [], [], []
    for m in rows:
        if not m.name.endswith(".topk"):
            continue
        key = m.tags[-1]
        if not key.startswith("key:k"):
            raise AssertionError(f"top-k member came back as {key!r}")
        series.append(int(m.name[len(prefix):-len(".topk")]))
        members.append(int(key[5:]))
        est.append(m.value)
    got = np.array(series, np.int64) * HH_KEYS + np.array(members)
    est = np.array(est)
    idx = np.searchsorted(exact["codes"], got)
    idx = np.minimum(idx, len(exact["codes"]) - 1)
    if not np.all(exact["codes"][idx] == got):
        raise AssertionError("a top-k row names a key its series never sent")
    want = exact["counts"][idx]
    bound = math.e / width * exact["total"]
    if np.any(est < want):
        raise AssertionError("a top-k estimate is below its exact count")
    over_share = float(np.mean(est - want > bound)) if len(est) else 0.0
    if over_share > math.exp(-depth):
        raise AssertionError(f"{over_share:.4f} of the estimates exceed "
                             f"exact + e/w*N = {bound:.1f}")
    # the K-th exact count of each series, and the keys that must show
    ser = exact["codes"] // HH_KEYS
    order = np.lexsort((-exact["counts"], ser))
    s_sorted, c_sorted = ser[order], exact["counts"][order]
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    sizes = np.diff(np.r_[starts, len(s_sorted)])
    kth = np.where(sizes >= k, c_sorted[starts + np.minimum(sizes, k) - 1],
                   0)
    kth_of = dict(zip(s_sorted[starts].tolist(), kth.tolist()))
    need = exact["counts"] > np.array([kth_of[s] for s in ser.tolist()]) \
        + bound
    missing = np.setdiff1d(exact["codes"][need], got)
    if len(missing):
        raise AssertionError(f"{len(missing)} heavy keys are missing")
    top1 = c_sorted[starts]
    top1_codes = exact["codes"][order][starts]
    return {"topk_rows": len(est), "series": len(starts),
            "distinct_keys_sent": len(exact["codes"]),
            "share_of_keys_emitted": len(est) / len(exact["codes"]),
            "top1_present_share": float(np.isin(top1_codes, got).mean()),
            "top1_exact_max": int(top1.max()),
            "over_mean": float(np.mean(est - want)),
            "over_max": float(np.max(est - want)),
            "cm_bound": bound, "over_bound_share": over_share,
            "keys_required": int(need.sum())}


def _timed_updates(group) -> list:
    """CUDA events around each count-min update the group's drains run
    (the wrapper rides the flush's fresh twin too)."""
    import torch

    events = []
    real = group._update

    def timed(sk, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(sk, *args)
        b.record()
        events.append((a, b))
        return out

    group._update = timed
    return events


def cm_update_alone(dev, series: int = HH_SERIES, batch: int = 1 << 14,
                    reps: int = 10) -> dict:
    """One count-min update at the phase's shape (a [65,536, 32] top-k,
    the default table, a 16,384-sample drain of Zipf members over random
    series) with no other thread in the process: CUDA events around each
    call (the span covers the host's enqueue too, since nothing waits
    between calls), and the device kernels' own time from a profiler
    trace of one call (None when the trace holds no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from veneur_tpu_torch.ops import countmin as cm

    gen = np.random.default_rng(SEED + 13)
    w = 1.0 / np.arange(1, HH_KEYS + 1) ** HH_ZIPF_S
    sk = cm.init(series, device=dev)

    def batch_args():
        rows = gen.integers(0, series, batch)
        keys = gen.choice(HH_KEYS, batch, p=w / w.sum()).astype(np.uint64)
        hashes = keys * np.uint64(0x9E3779B97F4A7C15)
        hi = (hashes >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = hashes.astype(np.uint32).view(np.int32)
        sids = (rows * 2654435761 % (1 << 32)).astype(np.uint32)
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                (rows, sids.view(np.int32), hi, lo,
                 np.ones(batch, np.float32))]

    for _ in range(3):
        sk = cm.update(sk, *batch_args())
    ms = []
    for _ in range(reps):
        args = batch_args()
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sk = cm.update(sk, *args)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    args = batch_args()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sk = cm.update(sk, *args)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = (sum(e.device_time for e in kernels) / 1e3) if kernels else None
    return {"update_ms_median": float(np.median(ms)),
            "update_ms_min": float(np.min(ms)),
            "device_kernels": len(kernels), "device_ms": dev_ms}


def _send_paced(senders, counts, done, lines_in, timeout=300):
    """Send every datagram, one window a call to ``senders.send``,
    waiting after each until ``done()`` reaches the lines sent so far
    (``lines_in(n)``: the lines of the first n datagrams)."""
    per = INGEST_MAX_WINDOW // INGEST_SENDERS
    sent = 0
    for a in range(0, max(senders.counts), per):
        sent += senders.send(a, a + per)
        target = lines_in(min(2 * (a + per), counts))
        _wait_for(lambda: done() >= target, timeout,
                  "the server to take a window")
    return sent


def run_heavy_hitters(dev, t, workdir, sock_path):
    """The two Servers of the heavy_hitters phase on ``dev``: A on the
    default lane fleet (4 lanes) takes three quarters of the top-k
    series and the histograms, B (the C++ pool with ``ingest_lanes:
    -1``, and a unix:// SSF listener) the rest; each flushed once, held
    to the exact counts. Returns (record, launch counts)."""
    import torch

    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    common = dict(interval="86400s", percentiles=list(INGEST_PERCENTILES),
                  aggregates=["min", "max", "count"], hostname="smoke",
                  read_buffer_size_bytes=8 << 20, num_readers=4)
    sink_a, sink_b = ChannelMetricSink(), ChannelMetricSink()
    a = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                      **common), metric_sinks=[sink_a], device=dev)
    b = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                      ingest_lanes=-1,
                      ssf_listen_addresses=[f"unix://{sock_path}"],
                      span_channel_capacity=4096, **common),
               metric_sinks=[sink_b], device=dev)
    a.start()
    b.start()
    senders = []
    rec = {}
    try:
        hh = a.store.heavy_hitters
        cfg = (hh.depth, hh.width, hh.k)
        if cfg != (4, 1 << 16, 32) or a.listeners[0][1] != "lanes" \
                or b.listeners[0][1] != "native" \
                or hh.sketch.table.device.type != dev.type:
            raise AssertionError(f"the Servers came up as {a.listeners}, "
                                 f"{b.listeners}, top-k {cfg}")
        fleet = a.ingest_fleets[0]
        updates = _timed_updates(hh)
        emit_a = _emission_timer(a.store)
        gc.collect()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts(tc)
        lanes, pool = t["lanes"], t["pool"]
        senders.append(_PacedSenders(fleet.bound[0][1], lanes,
                                     workdir / "a"))
        cum_a = np.concatenate([[0], np.cumsum(lanes["d_lines"])])
        t0 = time.perf_counter()
        sent_a = _send_paced(senders[0], len(lanes["d_len"]),
                             lambda: fleet.totals()["merged"],
                             lambda n: cum_a[n])
        _wait_for(lambda: fleet.totals()["merged"] >= lanes["lines"], 300,
                  "every line to merge into A")
        wall_a = time.perf_counter() - t0
        spilled_a = _spilled(a.store)
        totals = fleet.totals()
        senders.append(_PacedSenders(b.statsd_addrs[0][1], pool,
                                     workdir / "b"))
        cum_b = np.concatenate([[0], np.cumsum(pool["d_lines"])])
        t1 = time.perf_counter()
        sent_b = _send_paced(senders[1], len(pool["d_len"]),
                             lambda: b.store.processed, lambda n: cum_b[n])
        frames = _hh_spans(*t["ssf"])
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as tx:
            tx.connect(sock_path)
            for j in range(0, len(frames), 256):
                tx.sendall(b"".join(frames[j:j + 256]))
                want = pool["lines"] + 16 * min(j + 256, len(frames))
                want = min(want, pool["lines"] + len(t["ssf"][0]))
                _wait_for(lambda: b.store.processed >= want
                          or b.overload.shed_total() or b.spans_dropped,
                          120, "the SSF stream to merge")
        wall_b = time.perf_counter() - t1
        processed_a = a.store.processed
        processed_b = b.store.processed
        spilled_b = _spilled(b.store)
        t2 = time.perf_counter()
        a.flush()
        flush_a = time.perf_counter() - t2
        t3 = time.perf_counter()
        b.flush()
        flush_b = time.perf_counter() - t3
        counts = _counts(tc)
        rows_a = sink_a.get_flush(timeout=120)
        rows_b = sink_b.get_flush(timeout=120)
        torch.cuda.synchronize(dev)
        drain_ms = [e0.elapsed_time(e1) for e0, e1 in updates]
        mem = int(torch.cuda.max_memory_allocated(dev))
        rec.update({
            "lanes": fleet.num_lanes, "datagrams_a": sent_a,
            "lines_a": lanes["lines"], "ingest_a_s": wall_a,
            "records_per_s_a": lanes["lines"] / wall_a,
            "kernel_drops_a": _udp_drops(fleet.bound[0][1]),
            "datagrams_b": sent_b, "lines_b": pool["lines"],
            "ssf_spans_b": len(frames), "ssf_samples_b": len(t["ssf"][0]),
            "ingest_b_s": wall_b,
            "records_per_s_b": (processed_b) / wall_b,
            "kernel_drops_b": _udp_drops(b.statsd_addrs[0][1]),
            "cm_drains": len(drain_ms),
            "cm_update_ms_median": float(np.median(drain_ms)),
            "cm_update_ms_max": float(np.max(drain_ms)),
            "cm_update_ms_total": float(np.sum(drain_ms)),
            "flush_a_s": flush_a, "flush_b_s": flush_b,
            "emit_a_s": emit_a["emit_s"],
            "emission_share_a": emit_a["emit_s"] / flush_a,
            "max_memory_allocated": mem, "launches": counts,
            "overload": [a.overload.snapshot(), b.overload.snapshot()],
            "spilled": [spilled_a, spilled_b]})
        cons_a = (totals["packets"] == sent_a == len(lanes["d_len"])
                  and totals["merged"] == lanes["lines"]
                  and totals["parse_errors"] == totals["quarantined"] == 0
                  and totals["shed_packets"] == totals["shed_records"] == 0
                  and processed_a == lanes["lines"])
        cons_b = (processed_b == pool["lines"] + len(t["ssf"][0])
                  and b.packet_errors == b.quarantined == 0
                  and b.spans_dropped == 0)
        if not (cons_a and cons_b and rec["kernel_drops_a"] == 0
                and rec["kernel_drops_b"] == 0
                and a.overload.shed_total() == b.overload.shed_total() == 0
                and spilled_a == spilled_b == 0):
            raise AssertionError(f"heavy hitters did not conserve the "
                                 f"traffic: {rec} {totals}")
    finally:
        for s in senders:
            s.close()
        a.shutdown()
        b.shutdown()
    route, owner, keys = t["route"], t["owner"], t["keys"]
    rec["a"] = _check_topk(rows_a, _hh_exact(owner[route == 0],
                                             keys[route == 0]), cfg[2],
                           cfg[0], cfg[1])
    rec["b"] = _check_topk(rows_b, _hh_exact(owner[route > 0],
                                             keys[route > 0]), cfg[2],
                           cfg[0], cfg[1])
    hist = {m.name: m.value for m in rows_a if m.name.startswith("hh.h.")}
    for i in range(0, HH_HIST_SERIES, 4099):
        qi = t["q"][i]
        if (hist[f"hh.h.{i}.count"], hist[f"hh.h.{i}.min"],
                hist[f"hh.h.{i}.max"]) != (16.0 if i % 4 == 0 else 8.0,
                                           qi.min(), qi.max()):
            raise AssertionError(f"hh.h.{i}: count/min/max wrong")
    if len(hist) != HH_HIST_SERIES * (3 + len(INGEST_PERCENTILES)):
        raise AssertionError(f"{len(hist)} histogram rows flushed")
    if counts["compress_presorted.launches"] < 1 \
            or counts["drain_quantile.launches"] < 1:
        raise AssertionError(f"want K2 >= 1 and K1 >= 1: {counts}")
    return rec, counts


def run_hh_eviction(dev, batch: int = 4096) -> dict:
    """Top-k selection under eviction at the default geometry: the main
    run's series see 32 samples each, so no list ever evicts there.
    Here HH_EVICT_SERIES series of HH_EVICT_SAMPLES / HH_EVICT_SERIES
    Zipf(1.1) samples each go through ``process_batch`` (``batch``
    lines a call) into a store on ``dev`` and one on the CPU, in the
    same calls, so both drain alike. Their ``.topk`` rows must match
    exactly (the table sums integer counts below 2^24, exact in any
    order; the selection sorts stably on both devices), and they are
    held to the exact counts by _check_topk, whose presence check binds
    here. Returns the record."""
    import torch

    from veneur_tpu_torch import native
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    rng = np.random.default_rng(SEED + 11)
    w = 1.0 / np.arange(1, HH_KEYS + 1) ** HH_ZIPF_S
    keys = rng.choice(HH_KEYS, HH_EVICT_SAMPLES, p=w / w.sum())
    owner = rng.permutation(np.repeat(np.arange(HH_EVICT_SERIES),
                                      HH_EVICT_SAMPLES // HH_EVICT_SERIES))
    lines = [f"hh.e.{o}:k{m}|s|#veneurtopk".encode()
             for o, m in zip(owner.tolist(), keys.tolist())]
    blobs = [b"\n".join(lines[i:i + batch])
             for i in range(0, len(lines), batch)]
    del lines
    rec, out = {"series": HH_EVICT_SERIES, "samples": HH_EVICT_SAMPLES}, []
    for d in (dev, torch.device("cpu")):
        store = MetricStore(device=d)
        if store.heavy_hitters.sketch.table.device.type != d.type:
            raise AssertionError("the count-min table is off its device")
        t0 = time.perf_counter()
        for blob in blobs:
            store.process_batch(native.parse_lines(blob))
        if store.processed != HH_EVICT_SAMPLES:
            raise AssertionError(f"{store.processed} eviction samples "
                                 "processed")
        final = store.flush([], HistogramAggregates.from_names(["count"]),
                            0)[0].to_intermetrics()
        rec[f"{d.type}_s"] = time.perf_counter() - t0
        out.append({(m.name, tuple(m.tags)): m.value for m in final})
    if out[0] != out[1]:
        diff = sum(out[0].get(k) != v for k, v in out[1].items())
        raise AssertionError(f"the card's top-k differs from the CPU's in "
                             f"{diff} of {len(out[1])} rows")
    rec.update(_check_topk(final, _hh_exact(owner, keys), 32, 4, 1 << 16,
                           prefix="hh.e."))
    if rec["keys_required"] == 0:
        raise AssertionError("no key was required: the presence check "
                             "did not bind")
    return rec


def _hh_local_lines(rng, series: int, keys: int):
    """Lines of one forwarding local: series hh.f.<i>, keys k0..k<keys-1>
    with counts 4 * (keys - j) plus 0..3 (so every key recurs over
    several drains), beside 64 histograms of 4 samples and a global
    counter (10 x 1) that both body formats carry, shuffled; and the
    exact counts."""
    counts = 4 * (keys - np.arange(keys))[None, :] + rng.integers(
        0, 4, (series, keys))
    lines = [f"hh.f.{i}:k{j}|s|#veneurtopk"
             for i in range(series) for j in range(keys)
             for _ in range(int(counts[i, j]))]
    lines += [f"hh.fh.{i % 64}:{i}|h" for i in range(256)]
    lines += ["hh.fc:1|c|#veneurglobalonly"] * 10
    order = rng.permutation(len(lines))
    return [lines[j] for j in order], counts


def run_hh_forward(dev, compat: bool) -> dict:
    """Two port locals with HH_FWD_SERIES top-k series each (taken over
    UDP by their lane fleets) forward to a port global over HTTP, in our
    body format (the topk_sketch entry) or the reference's (``compat``:
    no sketch, so each local emits its own top-k). Held to the sums of
    the locals' exact counts within the count-min bound. Returns the
    record."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    rng = np.random.default_rng(SEED + 11)
    gsink = ChannelMetricSink()
    glob = Server(Config(http_address="127.0.0.1:0", interval="86400s",
                         percentiles=[0.5], hostname="g"),
                  metric_sinks=[gsink], device=dev)
    glob.start()
    rec = {"format": "reference" if compat else "structured"}
    exact = np.zeros((HH_FWD_SERIES, HH_FWD_KEYS), np.int64)
    local_rows, local_exact = [], []
    try:
        for n in range(2):
            lines, counts = _hh_local_lines(rng, HH_FWD_SERIES, HH_FWD_KEYS)
            exact += counts
            local_exact.append(counts)
            lsink = ChannelMetricSink()
            local = Server(Config(
                statsd_listen_addresses=["udp://127.0.0.1:0"],
                interval="86400s", hostname=f"l{n}",
                forward_address=f"http://127.0.0.1:{glob.ops_server.port}",
                forward_reference_compatible=compat),
                metric_sinks=[lsink], device=dev)
            local.start()
            try:
                fleet = local.ingest_fleets[0]
                packed = _pack_lines(lines)
                cum = np.concatenate([[0], np.cumsum(packed["d_lines"])])
                t0 = time.perf_counter()
                _udp_send(fleet.bound[0][1], _datagrams(packed),
                          lambda k: fleet.totals()["merged"] >= cum[k])
                rec[f"local{n}_ingest_s"] = time.perf_counter() - t0
                state_types = []
                real = local.forwarder.body

                def body(state, _real=real, _types=state_types):
                    out = _real(state)
                    _types.extend(d["type"] for d in out)
                    return out

                local.forwarder.body = body
                t1 = time.perf_counter()
                local.flush()
                if local.wait_forward(120) is not True:
                    raise AssertionError("the forward failed")
                rec[f"local{n}_flush_forward_s"] = time.perf_counter() - t1
                rec[f"local{n}_body_types"] = sorted(set(state_types))
                # the sinks have flushed when flush() returns, and
                # only when the local emitted something
                local_rows.append(lsink.queue.get_nowait()
                                  if not lsink.queue.empty() else [])
            finally:
                local.shutdown()
        _wait_for(lambda: glob.ops_server.import_pool.merged_batches >= 2,
                  120, "the global to merge both bodies")
        t2 = time.perf_counter()
        glob.flush()
        rec["global_flush_s"] = time.perf_counter() - t2
        grows = gsink.get_flush(timeout=60)
    finally:
        glob.shutdown()
    total = int(exact.sum())
    bound = math.e / (1 << 16) * total

    def topk(rows):
        out = {}
        for m in rows:
            if m.name.startswith("hh.f.") and m.name.endswith(".topk"):
                out[(int(m.name[5:-5]), int(m.tags[-1][5:]))] = m.value
        return out

    fleet = topk(grows)
    by = {m.name: m.value for m in grows}
    # the imported digests' median: hh.fh.0 holds 0, 64, 128, 192 twice
    if by.get("hh.fc") != 20.0 or not 0 <= by.get(
            "hh.fh.0.50percentile", -1) <= 192:
        raise AssertionError("the digests and counters did not reach the "
                             f"global: {by.get('hh.fc')}, "
                             f"{by.get('hh.fh.0.50percentile')}")
    if compat:
        # no sketch on the reference's wire: the global has none, and
        # each local emitted its own view
        if fleet or any("topk_sketch" in rec[f"local{n}_body_types"]
                        for n in range(2)):
            raise AssertionError("a reference-format forward carried the "
                                 "heavy-hitter sketch")
        views = [topk(r) for r in local_rows]
        for v, ex in zip(views, local_exact):
            if len(v) != HH_FWD_SERIES * HH_FWD_KEYS or any(
                    c < ex[i, j] for (i, j), c in v.items()):
                raise AssertionError("a compat local's own top-k is short "
                                     "or under its exact counts")
        rec["local_topk_rows"] = [len(v) for v in views]
    else:
        if not all("topk_sketch" in rec[f"local{n}_body_types"]
                   for n in range(2)) or any(topk(r) for r in local_rows):
            raise AssertionError("the sketch did not ride the forward, or "
                                 "a forwarding local emitted top-k rows")
        if len(fleet) != HH_FWD_SERIES * HH_FWD_KEYS:
            raise AssertionError(f"{len(fleet)} fleet top-k rows")
        over = np.array([fleet[(i, j)] - exact[i, j]
                         for i in range(HH_FWD_SERIES)
                         for j in range(HH_FWD_KEYS)])
        if over.min() < 0 or np.mean(over > bound) > math.exp(-4):
            raise AssertionError(f"fleet top-k off the summed exact counts:"
                                 f" {over.min()}..{over.max()}, bound "
                                 f"{bound:.2f}")
        rec.update(fleet_topk_rows=len(fleet), over_max=float(over.max()),
                   over_mean=float(over.mean()), cm_bound=bound)
    rec["samples"] = total
    return rec


def phase_heavy_hitters(dev, card: str) -> dict:
    """Heavy hitters at the default top-k geometry (run_heavy_hitters),
    then the local -> global forward in both body formats
    (run_hh_forward). Returns the launch counts of the main path."""
    import tempfile

    t0 = time.perf_counter()
    t = _hh_traffic()
    rec = {"topk_series": HH_SERIES, "topk_samples": HH_SAMPLES,
           "zipf_s": HH_ZIPF_S, "keys": HH_KEYS,
           "histogram_series": HH_HIST_SERIES,
           "traffic_build_s": time.perf_counter() - t0}
    workdir = Path(__file__).resolve().parent / "build" / "hh_smoke"
    sock_dir = Path(tempfile.mkdtemp(prefix="vhh"))
    try:
        run, counts = run_heavy_hitters(dev, t, workdir,
                                        str(sock_dir / "ssf.sock"))
    finally:
        (sock_dir / "ssf.sock").unlink(missing_ok=True)
        sock_dir.rmdir()
    rec.update(run)
    del t
    rec["cm_update_alone"] = cm_update_alone(dev)
    rec["eviction"] = run_hh_eviction(dev)
    rec["forward"] = [run_hh_forward(dev, compat) for compat in (False,
                                                                 True)]
    rec["phase_s"] = time.perf_counter() - t0
    emit({"phase": "heavy_hitters", "card": card, **rec})
    return counts


# the overload phase: the default config's bounds and the shed ladder

OV_MAX_SERIES = 4096
OV_COUNTERS = 40000
OV_HISTOGRAMS = 8192
OV_EXEMPT = 256                  # veneur.* gauges sent under the freeze
OV_TAG_LINES = 1001              # the F1 line and 1,000 like it
OV_TAGS = [f"t{i}:" + "x" * 40 for i in range(40)]   # 1,789 B joined


def _udp_send(port: int, datagrams, done, per: int = 128,
              timeout: float = 120) -> None:
    """Send ``datagrams`` to ``port`` from one socket, ``per`` at a time,
    waiting after each burst until ``done(n)`` holds for the n sent."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i in range(0, len(datagrams), per):
            for d in datagrams[i:i + per]:
                tx.sendto(d, ("127.0.0.1", port))
            n = min(i + per, len(datagrams))
            _wait_for(lambda: done(n), timeout, "the server to take a burst")


def run_series_cap(dev) -> tuple:
    """A Server on the lane fleet with ``max_series: 4096`` and the default
    watermarks takes 40,000 counter and 8,192 histogram series (one
    sample each, shuffled), then 256 ``veneur.*`` and 256 other gauges.
    The counter group passes 70% of its cap, which holds the controller
    at the freeze tier: from then on every first-sight series spills
    (the cap binds only where the freeze lags), the ``veneur.*`` ones
    excepted. Every spilled sample lands in its group's overflow row:
    the counter sum and the digest count equal the spilled samples, and
    ``spilled`` equals their number."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    cvals = np.arange(OV_COUNTERS) % 97 + 1
    lines = [f"ov.c.{i}:{v}|c" for i, v in enumerate(cvals.tolist())]
    lines += [f"ov.h.{i}:{i % 1000}|h" for i in range(OV_HISTOGRAMS)]
    order = np.random.default_rng(SEED + 12).permutation(len(lines))
    lines = [lines[j] for j in order]
    late = [f"veneur.smoke.g.{i}:{i}|g" for i in range(OV_EXEMPT)]
    late += [f"ov.g.{i}:{i}|g" for i in range(OV_EXEMPT)]
    sink = ChannelMetricSink()
    server = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                           num_readers=4, max_series=OV_MAX_SERIES,
                           interval="86400s", percentiles=[0.5],
                           aggregates=["min", "max", "count"],
                           hostname="smoke"),
                    metric_sinks=[sink], device=dev)
    server.start()
    ctl = server.overload
    rec = {"max_series": OV_MAX_SERIES, "counters_sent": OV_COUNTERS,
           "histograms_sent": OV_HISTOGRAMS}
    try:
        fleet = server.ingest_fleets[0]
        port = fleet.bound[0][1]
        t0 = time.perf_counter()
        first = _pack_lines(lines)
        cum = np.concatenate([[0], np.cumsum(first["d_lines"])])
        _udp_send(port, _datagrams(first),
                  lambda n: fleet.totals()["merged"] >= cum[n])
        _wait_for(lambda: ctl.level() >= 1, 30, "the freeze")
        rec["level_after_flood"] = ctl.level()
        rec["pressure_after_flood"] = ctl.pressure()
        second = _pack_lines(late)
        _udp_send(port, _datagrams(second),
                  lambda n: fleet.totals()["merged"]
                  >= len(lines) + len(late) * n // len(second["d_len"]))
        _wait_for(lambda: fleet.totals()["merged"] >= len(lines) + len(late),
                  60, "every line to merge")
        rec["ingest_s"] = time.perf_counter() - t0
        store = server.store
        spilled = {g: getattr(store, g).spilled
                   for g in ("counters", "histograms", "gauges")}
        sizes = {g: len(getattr(store, g))
                 for g in ("counters", "histograms", "gauges")}
        _reset_counts(tc)
        t1 = time.perf_counter()
        server.flush()
        rec["flush_s"] = time.perf_counter() - t1
        counts = _counts(tc)
        rows = sink.get_flush(timeout=60)
        rec.update(level_changes=ctl.level_changes, spilled=spilled,
                   group_rows=sizes, shed=dict(ctl.shed),
                   kernel_drops=_udp_drops(port))
    finally:
        server.shutdown()
    by = {(m.name, tuple(m.tags)): m.value for m in rows}
    kept_c = [int(n.split(".")[2]) for n, _ in by if n.startswith("ov.c.")]
    kept_h = {int(n.split(".")[2]) for n, _ in by if n.startswith("ov.h.")
              and n.endswith(".count")}
    over_c = by[("veneur.overload.overflow", ("group:counters",))]
    over_h = by[("veneur.overload.overflow.count", ("group:histograms",))]
    exempt = [by.get((f"veneur.smoke.g.{i}", ())) for i in range(OV_EXEMPT)]
    checks = {
        "counter_rows_capped": sizes["counters"] <= OV_MAX_SERIES,
        "counters_spilled": spilled["counters"] == OV_COUNTERS - len(kept_c),
        "counter_overflow_sum": over_c == float(
            cvals.sum() - cvals[kept_c].sum()),
        "histograms_spilled": spilled["histograms"]
        == OV_HISTOGRAMS - len(kept_h) == over_h,
        "histogram_rows_capped": sizes["histograms"] <= OV_MAX_SERIES,
        "veneur_exempt": exempt == [float(i) for i in range(OV_EXEMPT)],
        "others_frozen": spilled["gauges"] == OV_EXEMPT
        and not any(n.startswith("ov.g.") for n, _ in by),
        "nothing_shed": sum(rec["shed"].values()) == 0
        and rec["kernel_drops"] == 0,
        "k1": counts["drain_quantile.launches"] >= 1}
    rec["checks"] = checks
    rec.update(counter_overflow=over_c, histogram_overflow_count=over_h,
               kept_counters=len(kept_c), kept_histograms=len(kept_h))
    if not all(checks.values()):
        raise AssertionError(f"the series cap: {rec}")
    return rec, counts


def run_tag_cap(dev, sock_path) -> dict:
    """The F1 line (40 tags, 1,789 bytes joined) and 1,000 like it, each
    its own series, through the default config on every rung: the lane
    fleet, the C++ pool, the Python readers, and SSF over a unix://
    listener. Every rung keys the tags truncate_joined_tags leaves (987
    bytes) and counts each line in ``oversized_tags``."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.protocol import ssf, wire
    from veneur_tpu_torch.samplers.parser import truncate_joined_tags
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    joined = ",".join(OV_TAGS)
    cut = truncate_joined_tags(",".join(sorted(OV_TAGS)), 1024)
    want_tags = tuple(cut.split(","))
    lines = [f"f1.{i}:1|c|#{joined}".encode() for i in range(OV_TAG_LINES)]
    rec = {"tags_joined_bytes": len(joined), "cut_bytes": len(cut)}
    rungs = {"lanes": {}, "native": {"ingest_lanes": -1},
             "python": {"ingest_lanes": -1, "native_ingest": False,
                        "ssf_listen_addresses": [f"unix://{sock_path}"],
                        "span_channel_capacity": 4096}}
    for rung, extra in rungs.items():
        sink = ChannelMetricSink()
        server = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                               interval="86400s", hostname="smoke",
                               **extra), metric_sinks=[sink], device=dev)
        server.start()
        try:
            if server.listeners[0][1] != rung:
                raise AssertionError(f"{rung} came up as "
                                     f"{server.listeners[0][1]}")
            t0 = time.perf_counter()
            _udp_send(server.statsd_addrs[0][1], lines,
                      lambda n: server.store.processed >= n, per=64)
            want = OV_TAG_LINES
            if rung == "python":
                tags = {t.split(":")[0]: "x" * 40 for t in OV_TAGS}
                with socket.socket(socket.AF_UNIX,
                                   socket.SOCK_STREAM) as tx:
                    tx.connect(sock_path)
                    for i in range(OV_TAG_LINES):
                        body = ssf.encode_span(ssf.SSFSpan(
                            trace_id=i + 1, id=i + 1, start_timestamp=1,
                            end_timestamp=2, metrics=[ssf.SSFSample(
                                metric=ssf.SSFSample.COUNTER,
                                name=f"f1s.{i}", value=1.0, tags=tags)]))
                        tx.sendall(wire.FRAME_HEADER.pack(0, len(body))
                                   + body)
                want += OV_TAG_LINES
            _wait_for(lambda: server.store.processed >= want
                      or server.overload.shed_total(), 120,
                      f"the {rung} rung")
            wall = time.perf_counter() - t0
            oversized = server.store.quarantine.snapshot()["oversized_tags"]
            server.flush()
            rows = sink.get_flush(timeout=60)
        finally:
            server.shutdown()
        tagsets = {tuple(m.tags) for m in rows}
        rec[rung] = {"lines": want, "rows": len(rows),
                     "oversized_tags": oversized, "wall_s": wall,
                     "shed": server.overload.shed_total()}
        # the SSF samples' "k:v" tags are the same strings
        if not (len(rows) == want and oversized == want
                and tagsets == {want_tags}):
            raise AssertionError(f"the tag cap on {rung}: {rec[rung]}")
    return rec


def run_shed_ladder(dev, sock_path) -> dict:
    """A Server on the lane fleet with a unix:// SSF listener; its span
    channel is forced full (a queue nobody drains stands in for it). At
    90% the controller sheds spans (level 2), at 100% statsd datagrams
    at the lanes' sockets (level 3); every shed span and datagram is
    counted in ``overload.shed``, none lost uncounted. Drained again,
    the ladder falls to 0 and the same datagrams merge."""
    import queue as queue_mod

    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.protocol import ssf, wire
    from veneur_tpu_torch.server import Server

    server = Server(Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                           num_readers=4,
                           ssf_listen_addresses=[f"unix://{sock_path}"],
                           interval="86400s", hostname="smoke"), device=dev)
    server.start()
    ctl = server.overload
    rec = {"watermarks": [ctl.low, ctl.high, ctl.hard]}
    spans, dgrams = 500, 1000
    try:
        fleet = server.ingest_fleets[0]
        port = fleet.bound[0][1]
        chan = server.span_chan = queue_mod.Queue(100)
        for _ in range(90):
            chan.put_nowait(ssf.SSFSpan(id=0))
        _wait_for(lambda: ctl.level() == 2, 10, "level 2")
        rec["level_spans"], rec["pressure_spans"] = ctl.level(), \
            ctl.pressure()
        t0 = time.perf_counter()
        frame = ssf.encode_span(ssf.SSFSpan(trace_id=1, id=1,
                                            start_timestamp=1,
                                            end_timestamp=2))
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as tx:
            tx.connect(sock_path)
            tx.sendall((wire.FRAME_HEADER.pack(0, len(frame)) + frame)
                       * spans)
        _wait_for(lambda: ctl.shed["spans"] >= spans, 30, "spans shed")
        rec["spans_shed_s"] = time.perf_counter() - t0
        for _ in range(10):
            chan.put_nowait(ssf.SSFSpan(id=0))
        _wait_for(lambda: ctl.level() == 3 and ctl.level_nowait() == 3, 10,
                  "level 3")
        rec["level_packets"], rec["pressure_packets"] = ctl.level(), \
            ctl.pressure()
        payloads = [f"ladder.c.{i % 16}:1|c".encode() for i in range(dgrams)]
        t1 = time.perf_counter()
        _udp_send(port, payloads,
                  lambda n: fleet.totals()["packets"] >= n)
        _wait_for(lambda: ctl.shed["statsd"] >= dgrams, 30,
                  "the merger's shed roll-up")
        rec["statsd_shed_s"] = time.perf_counter() - t1
        rec["merged_while_shedding"] = fleet.totals()["merged"]
        while not chan.empty():
            chan.get_nowait()
        _wait_for(lambda: ctl.level() == 0, 10, "level 0")
        t2 = time.perf_counter()
        _udp_send(port, payloads,
                  lambda n: fleet.totals()["merged"] >= n)
        rec["recovered_s"] = time.perf_counter() - t2
        totals = fleet.totals()
        rec.update(shed=dict(ctl.shed), level_changes=ctl.level_changes,
                   packets=totals["packets"],
                   shed_packets=totals["shed_packets"],
                   merged=totals["merged"], spans_dropped=server.spans_dropped,
                   kernel_drops=_udp_drops(port),
                   processed=server.store.processed)
    finally:
        server.shutdown()
    if not (rec["shed"] == {"statsd": dgrams, "ssf": 0, "spans": spans}
            and rec["packets"] == 2 * dgrams == rec["shed_packets"]
            + rec["merged"] and rec["merged_while_shedding"] == 0
            and rec["processed"] == dgrams and rec["spans_dropped"] == 0
            and rec["kernel_drops"] == 0 and rec["level_changes"] >= 3):
        raise AssertionError(f"the shed ladder: {rec}")
    return rec


def phase_overload(dev, card: str) -> dict:
    """The series cap (run_series_cap), the tag cap on every rung
    (run_tag_cap) and the shed ladder (run_shed_ladder). Returns the
    launch counts of the series-cap Server's flush."""
    import tempfile

    t0 = time.perf_counter()
    sock_dir = Path(tempfile.mkdtemp(prefix="vov"))
    sock = str(sock_dir / "ssf.sock")
    try:
        cap, counts = run_series_cap(dev)
        rec = {"series_cap": cap, "tag_cap": run_tag_cap(dev, sock)}
        Path(sock).unlink(missing_ok=True)
        rec["ladder"] = run_shed_ladder(dev, sock)
    finally:
        Path(sock).unlink(missing_ok=True)
        sock_dir.rmdir()
    rec["phase_s"] = time.perf_counter() - t0
    emit({"phase": "overload", "card": card, **rec})
    return counts


CKPT_TOPK = 4096                 # the checkpoint phase's veneurtopk series
CKPT_SCALARS = 4096              # its counters and gauges
CKPT_ROWS = 1 << 18              # the checkpoint phase's histogram series
LADDER_ROWS = 1 << 16            # the compute_ladder subphase's series
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
_BREAKERS = []                   # the compute breaker of each store built


def _track_breakers() -> None:
    """Record the compute breaker of every MetricStore built from here on
    (a Server's included), so each phase can show that no store it ran
    ever left the kernel (:func:`_check_breakers`)."""
    from veneur_tpu_torch.core.store import MetricStore

    real = MetricStore.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        _BREAKERS.append(self.compute)

    MetricStore.__init__ = init


def _check_breakers(phase: str) -> int:
    """Every store the phase built ended with requeued_total and
    lost_total at 0: a run in which the kernel gave way anywhere fails.
    Returns the number of stores checked."""
    seen = list(_BREAKERS)
    _BREAKERS.clear()
    bad = [b.snapshot() for b in seen
           if b.requeued_total or b.lost_total]
    if bad:
        raise AssertionError(f"{phase}: the compute ladder left the kernel: "
                             f"{bad}")
    return len(seen)


def _checkpoint_traffic(rows: int, set_series: int, scalars: int,
                        topk: int) -> dict:
    """The checkpoint phase's data, from the seed: 8 samples a histogram
    series at rate 0.5 (weight 2; four from gamma(2, 10), then four
    shifted +1000, so the shift guard drains through K2 on ingest), 16
    members a set, counter and gauge values, and 16 Zipf(1.1) members a
    veneurtopk series."""
    from veneur_tpu_torch.ops import hll as hll_ops

    rng = iter([np.random.default_rng(s) for s in
                np.random.SeedSequence(SEED + 9).spawn(8)])
    half = SAMPLES_PER_SERIES // 2
    t = {"rows": rows, "set_series": set_series, "scalars": scalars,
         "topk": topk,
         "early": next(rng).gamma(2.0, 10.0, (rows, half)).astype(
             np.float32),
         "late": (1000.0 + next(rng).gamma(2.0, 10.0, (rows, half))
                  ).astype(np.float32),
         "set_hashes": next(rng).integers(
             0, np.iinfo(np.uint64).max, (set_series, 16), dtype=np.uint64,
             endpoint=True),
         "counters": next(rng).integers(1, 1000, scalars),
         "gauges": next(rng).normal(0.0, 100.0, scalars)}
    keys = next(rng).zipf(1.1, (topk, 16)) % 4096
    t["topk_members"] = [f"m{k}".encode() for k in keys.reshape(-1)]
    t["topk_hashes"] = np.array([hll_ops.hash_member(m)
                                 for m in t["topk_members"]], np.uint64)
    return t


def _feed_checkpoint_store(store, t) -> None:
    """The traffic through the store API (not UDP, to save time): each
    group's series interned and its samples staged and drained in one
    store-lock hold, so a snapshot holds all of a group or none of it."""
    from veneur_tpu_torch.samplers.parser import MetricKey

    rows, sets, scal, tk = t["rows"], t["set_series"], t["scalars"], t["topk"]
    half = SAMPLES_PER_SERIES // 2
    with store._lock:
        hist = store.histograms
        for i in range(rows):
            hist.interner.intern(MetricKey(f"ck.h.{i}", "histogram", ""), [])
        hist.ensure_capacity(rows - 1)
        row_ids = np.repeat(np.arange(rows, dtype=np.int32), half)
        wts = np.full(rows * half, 2.0, np.float32)
        hist.sample_many(row_ids, t["early"].reshape(-1), wts)
        hist.sample_many(row_ids, t["late"].reshape(-1), wts)
        hist._drain_samples()
    with store._lock:
        g = store.sets
        for i in range(sets):
            g.interner.intern(MetricKey(f"ck.s.{i}", "set", ""), [])
        g.ensure_capacity(sets - 1)
        g.sample_many(np.repeat(np.arange(sets, dtype=np.int32), 16),
                      t["set_hashes"].reshape(-1))
        g._drain_samples()
    for attr, kind, prefix, vals in (
            ("counters", "counter", "ck.c", t["counters"]),
            ("gauges", "gauge", "ck.g", t["gauges"])):
        with store._lock:
            g = getattr(store, attr)
            for i in range(scal):
                g.interner.intern(MetricKey(f"{prefix}.{i}", kind, ""), [])
            g.ensure_capacity(scal - 1)
            if kind == "counter":
                g.add_many(np.arange(scal), vals.astype(np.int64))
            else:
                g.set_many(np.arange(scal), vals)
    with store._lock:
        hh = store.heavy_hitters
        hrows = np.array([hh._row(MetricKey(f"ck.k.{i}", "set",
                                            "veneurtopk"), ["veneurtopk"])
                          for i in range(tk)], np.int32)
        hh.sample_many(np.repeat(hrows, 16), t["topk_hashes"],
                       t["topk_members"])
        hh._drain_samples()


def _ckpt_covers(groups, t) -> bool:
    """Whether a committed checkpoint holds all of the traffic."""
    h = groups["histograms"]
    return (len(h["names"]) == t["rows"] and "count" in h
            and float(h["count"].sum()) == 2 * t["rows"] * SAMPLES_PER_SERIES
            and len(groups["sets"]["names"]) == t["set_series"]
            and len(groups["counters"]["names"]) == t["scalars"]
            and len(groups["gauges"]["names"]) == t["scalars"]
            and len(groups["heavy_hitters"]["names"]) == t["topk"])


def _instrument_checkpointer(server):
    """Time each checkpoint write of ``server`` by stage, around the
    store's and the format's own functions: ``lock_s`` the group holds of
    snapshot_begin (the staging drain and the device copies, under the
    store lock), ``fetch_s`` the off-lock finishes less ``flatten_s``
    (flatten_digest_state), then serialize and write+fsync. Returns (the
    list each write appends its record to, a function that removes the
    module-level wrappers)."""
    from veneur_tpu_torch.core import store as store_mod
    from veneur_tpu_torch.persist import format as ckpt_format

    writes, cur = [], {}
    store = server.store
    for name in store._GEN_GROUPS:
        def begin(real=getattr(store, name).snapshot_begin):
            snap, fin = _timed_into(cur, "lock_s", real)()
            return snap, fin and _timed_into(cur, "finish_s", fin)

        getattr(store, name).snapshot_begin = begin
    real_flatten, real_serialize = (store_mod.flatten_digest_state,
                                    ckpt_format.serialize)
    store_mod.flatten_digest_state = _timed_into(cur, "flatten_s",
                                                 real_flatten)
    ckpt_format.serialize = _timed_into(cur, "serialize_s", real_serialize)
    real_snapshot = store.snapshot_state

    def snapshot():
        cur.clear()
        cur.update(dict.fromkeys(("lock_s", "finish_s", "flatten_s",
                                  "serialize_s", "write_fsync_s"), 0.0))
        return real_snapshot()

    store.snapshot_state = snapshot
    timed_write = _timed_into(cur, "write_fsync_s", ckpt_format.write_atomic)

    def write(path, blob):
        cur["bytes"] = timed_write(path, blob)
        rec = dict(cur)
        rec["fetch_s"] = rec.pop("finish_s") - rec["flatten_s"]
        writes.append(rec)
        return cur["bytes"]

    server.checkpointer._write_fn = write

    def undo():
        store_mod.flatten_digest_state = real_flatten
        ckpt_format.serialize = real_serialize

    return writes, undo


def _traffic_block(blk):
    """A block without the server's own series (veneur.*: a Server's
    flush span, and a global's import spans, re-enter its pipeline), or
    None when it holds nothing else; the suffixes only those series
    emitted (their aggregates: a global's imported digests emit
    percentiles alone) are dropped too."""
    from veneur_tpu_torch.core.columnar import (EmissionBlock, arena_strings,
                                                build_arenas)

    names = arena_strings(blk.names)
    keep = np.array([not x.startswith("veneur.") for x in names], bool)
    if keep.all():
        return blk
    if not keep.any():
        return None
    tags = arena_strings(blk.tags)
    new_row = np.cumsum(keep) - 1
    sel = keep[blk.rows]
    used = np.unique(blk.suffix_idx[sel])
    new_sfx = np.zeros(len(blk.suffixes), blk.suffix_idx.dtype)
    new_sfx[used] = np.arange(len(used))
    return EmissionBlock(
        names=build_arenas([x for x, k in zip(names, keep) if k]),
        tags=build_arenas([x for x, k in zip(tags, keep) if k]),
        suffixes=[blk.suffixes[i] for i in used.tolist()],
        rows=new_row[blk.rows[sel]].astype(blk.rows.dtype),
        suffix_idx=new_sfx[blk.suffix_idx[sel]], values=blk.values[sel],
        type_codes=blk.type_codes[sel])


def _blocks_by_prefix(col, part: int = 1) -> dict:
    """A ColumnarFlush's blocks of the traffic (``_traffic_block``) keyed
    by the dotted ``part`` of their first name (the group prefix: "h",
    "s", "c" or "g" of ck.<p>.<i> at part 1, of <p>.<i> at part 0),
    each with its names."""
    from veneur_tpu_torch.core.columnar import arena_strings

    out = {}
    for blk in filter(None, map(_traffic_block, col.blocks)):
        names = arena_strings(blk.names)
        key = names[0].split(".")[part]
        if key in out:
            raise AssertionError(f"two blocks of group {key!r}")
        out[key] = (blk, names)
    return out


def _check_restored_flush(col, twin, t) -> dict:
    """The restored Server's flush against the uninterrupted twin's:
    counters, gauges and set estimates equal; per-row digest count exact,
    sum/min/max within rel 1e-4, percentiles within 0.02 x (max - min);
    the total weight conserved exactly; the top-k rows equal."""
    got, want = _blocks_by_prefix(col), _blocks_by_prefix(twin)
    if set(got) != {"h", "s", "c", "g"} or set(want) != set(got):
        raise AssertionError(f"blocks {sorted(got)} vs {sorted(want)}")
    rec = {}
    for key, (blk, names) in got.items():
        wblk, wnames = want[key]
        if names != wnames or blk.suffixes != wblk.suffixes:
            raise AssertionError(f"group {key}: names or suffixes differ")
        g, w = _block_matrix(blk), _block_matrix(wblk)
        if key != "h":
            if not np.array_equal(g, w):
                raise AssertionError(f"group {key}: values differ")
            continue
        sfx = [s.decode() for s in blk.suffixes]
        col_of = {s: i for i, s in enumerate(sfx)}
        cnt = g[:, col_of[".count"]]
        if not np.array_equal(cnt, w[:, col_of[".count"]]):
            raise AssertionError("digest counts differ")
        if float(cnt.sum()) != 2 * t["rows"] * SAMPLES_PER_SERIES:
            raise AssertionError(f"total weight {cnt.sum()} != "
                                 f"{2 * t['rows'] * SAMPLES_PER_SERIES}")
        for s in (".sum", ".min", ".max"):
            a, b = g[:, col_of[s]], w[:, col_of[s]]
            err = float(np.max(np.abs(a - b) / np.abs(b)))
            rec[f"rel_err{s.replace('.', '_')}"] = err
            if err > 1e-4:
                raise AssertionError(f"digest {s} off by {err:.3g}")
        span = w[:, col_of[".max"]] - w[:, col_of[".min"]]
        pc = [i for s, i in col_of.items() if s.endswith("percentile")]
        perr = float(np.max(np.abs(g[:, pc] - w[:, pc]) / span[:, None]))
        rec["pct_err_of_span"] = perr
        if perr > 0.02:
            raise AssertionError(f"percentiles off by {perr:.3g} of the "
                                 f"span")
    topk = sorted((m.name, tuple(m.tags), m.value) for m in col.extras)
    wtopk = sorted((m.name, tuple(m.tags), m.value) for m in twin.extras)
    if topk != wtopk or not topk:
        raise AssertionError(f"top-k rows differ ({len(topk)} vs "
                             f"{len(wtopk)})")
    rec["topk_rows"] = len(topk)
    return rec


def run_checkpoint(dev, t, aggs) -> tuple:
    """The main part of the checkpoint phase: a port Server on ``dev``
    with checkpoints every second takes the traffic; once a committed
    checkpoint covers all of it the Server is killed (crash_stop); a
    second Server on the same path restores it and flushes columnar.
    Held to an uninterrupted twin store fed the same traffic and flushed
    directly (before the counts reset: it is the reference). Returns
    (the phase's record, the launch counts of the main path)."""
    import shutil

    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.persist import deserialize, read_file
    from veneur_tpu_torch.persist import format as ckpt_format
    from veneur_tpu_torch.server import Server

    rec = {}
    t0 = time.perf_counter()
    twin = MetricStore(initial_capacity=1024, device=dev,
                       max_series=2 * t["rows"])
    _feed_checkpoint_store(twin, t)
    want, _ = twin.flush(list(PERCENTILES), aggs, 0, columnar=True)
    del twin
    gc.collect()
    rec["twin_s"] = time.perf_counter() - t0

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    path = str(CKPT_DIR / "veneur.ckpt")
    cfg = dict(interval="600s", percentiles=list(PERCENTILES),
               aggregates=["min", "max", "count", "sum"], hostname="smoke",
               max_series=2 * t["rows"], checkpoint_path=path,
               checkpoint_interval="1s")
    try:
        _reset_counts(tc)
        a = Server(Config(**cfg), metric_sinks=[_ColumnarRecorder()],
                   device=dev)
        writes, undo = _instrument_checkpointer(a)
        a.start()
        try:
            t0 = time.perf_counter()
            with _capture_launches(tc, "launch_compress_presorted") as \
                    k2_calls:
                _feed_checkpoint_store(a.store, t)
            _sync(dev)
            rec["ingest_s"] = time.perf_counter() - t0
            rec["ingest_k2"] = tc.compress_presorted.launches
            t0 = time.perf_counter()
            deadline = time.time() + 600
            while True:
                blob = read_file(path)
                if blob is not None and _ckpt_covers(deserialize(blob)[0],
                                                     t):
                    break
                if time.time() > deadline:
                    raise AssertionError("no committed checkpoint covered "
                                         "the traffic in 600 s")
                time.sleep(0.5)
            rec["covered_after_s"] = time.perf_counter() - t0
        finally:
            # a write in flight finishes before the "kill" returns: an
            # in-process kill cannot stop a thread, and a late write
            # must not race the restart
            a.crash_stop(timeout=600)
            undo()
        if any(th.name == "checkpoint" for th in threading.enumerate()):
            raise AssertionError("a checkpoint write outlived crash_stop")
        if not writes or a.checkpointer.write_errors:
            raise AssertionError(f"checkpoint writes {len(writes)}, errors "
                                 f"{a.checkpointer.write_errors}")
        rec["writes"] = len(writes)
        rec["last_write"] = writes[-1]
        rec["file_bytes"] = os.path.getsize(path)
        del a
        gc.collect()

        # the restart: restore (deserialize, intern, import drains,
        # restats) before any listener, then one columnar flush
        recorder = _ColumnarRecorder()
        b = Server(Config(**cfg), metric_sinks=[recorder], device=dev)
        split = dict.fromkeys(("deserialize_s", "restore_wall_s",
                               "restore_state_s", "histograms_group_s",
                               "import_bulk_s", "import_drains_s",
                               "restore_stats_s"), 0.0)
        split["import_drains"] = 0
        real_deser = ckpt_format.deserialize
        ckpt_format.deserialize = _timed_into(split, "deserialize_s",
                                              real_deser)
        bstore, bhist, ck = b.store, b.store.histograms, b.checkpointer
        ck.restore = _timed_into(split, "restore_wall_s", ck.restore)
        bstore.restore_state = _timed_into(split, "restore_state_s",
                                           bstore.restore_state)
        real_group = bstore._restore_group
        hist_group = _timed_into(split, "histograms_group_s", real_group)
        bstore._restore_group = lambda name, *a, **k: (
            hist_group if name == "histograms" else real_group)(name, *a,
                                                                **k)
        bhist.import_centroids_bulk = _timed_into(
            split, "import_bulk_s", bhist.import_centroids_bulk)
        bhist.restore_stats = _timed_into(split, "restore_stats_s",
                                          bhist.restore_stats)
        drain = _timed_into(split, "import_drains_s", bhist._drain_imports)

        def counted_drain():
            split["import_drains"] += 1
            return drain()

        bhist._drain_imports = counted_drain
        k2 = tc.compress_presorted.launches
        try:
            b.start()
        finally:
            ckpt_format.deserialize = real_deser
        _sync(dev)
        split["restore_k2"] = tc.compress_presorted.launches - k2
        split["intern_s"] = (split["histograms_group_s"]
                             - split["import_bulk_s"]
                             - split["restore_stats_s"])
        if ck.restore_total != 1 or ck.discard_total:
            raise AssertionError(f"restore_total {ck.restore_total}, "
                                 f"discard_total {ck.discard_total}")
        rec["restored_series"] = ck.restored_series
        rec["restore"] = split
        # K1 at the restored flush, its inputs and output kept to hold it
        # against its plain version on the same tensors
        t0 = time.perf_counter()
        with _capture_launches(tc, "launch_drain_quantile") as k1_calls:
            b.flush()
        rec["restored_flush_s"] = time.perf_counter() - t0
        counts = _counts(tc)
        # the flush truncated the checkpoint; B's own cadence may have
        # written the fresh (empty) interval since, never the restored one
        blob = read_file(path)
        if blob is not None and any(g["names"] for g in
                                    deserialize(blob)[0].values()):
            raise AssertionError("the restored state is still on disk "
                                 "after the flush")
        b.shutdown()
        col = recorder.flushes.get(timeout=60)
        rec.update(_check_restored_flush(col, want, t))
        if dev.type == "cuda":
            if not k1_calls or rec["ingest_k2"] < 1:
                raise AssertionError(f"K1 at the restored flush "
                                     f"{len(k1_calls)}x, K2 on ingest "
                                     f"{rec['ingest_k2']}x")
            rec["k1_restored_max_abs_err"] = _hold_to_plain(
                tc, "K1 at the restored flush", k1_calls[0])
            rec["k2_ingest_max_abs_err"] = _hold_to_plain(
                tc, "K2 on the checkpointed ingest", k2_calls[0])
        del k1_calls, k2_calls, b
        gc.collect()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return rec, counts


class _capture_launches:
    """Within the block, keep the arguments and outputs of every launch
    of ``tc.<name>`` (launch_drain_quantile or launch_compress_presorted:
    the wrappers call them only when they launch the kernel, and count
    the launch themselves), to hold the kernel against its plain version
    on the same tensors afterwards."""

    def __init__(self, tc, name: str):
        self.tc, self.name = tc, name
        self.real = getattr(tc, name)

    def __enter__(self) -> list:
        calls = []

        def launch(*args):
            out = self.real(*args)
            calls.append((args, out))
            return out

        setattr(self.tc, self.name, launch)
        return calls

    def __exit__(self, *exc):
        setattr(self.tc, self.name, self.real)


def _hold_to_plain(tc, what: str, call) -> float:
    """A captured launch against its plain version on the same inputs
    (:func:`_compare`'s bounds). Returns the max abs error."""
    args, out = call
    if len(out) == 3:   # K1: (..., mn, mx, qs, compression, out_size, sort_b)
        plain = tc.drain_quantile_plain(*args)
        span = args[5] - args[4]
    else:
        plain = tc.compress_presorted_plain(*args)
        span = None
    _sync(args[0].device)
    return _compare(what, out, plain, args[1], args[3], span=span)


def run_compute_ladder(dev, aggs, rows: int = LADDER_ROWS) -> tuple:
    """The compute_ladder subphase on ``dev`` at ``rows`` histogram series
    x 8 samples:

    * a kernel fault: a FaultInjector fails rung 1 at preflight; the
      flush launches nothing and re-merges the interval into the live
      store (rung 3), and the next flush emits it through K1 (held to
      its plain version), its rows held to a twin store that never
      failed (count, min, max equal, sum within rel 1e-6, percentiles
      within 0.02 x span, the checkpoint round trip's bound); the walls
      of the faulted flush (the re-merge), the late flush and the
      twin's flush are printed;
    * the breaker: two more faults open it; a flush while it is open
      re-merges without a launch and without spending the probe, while
      the staging drains go on through K2 (a shifted chunk trips the
      guard); past the reset timeout on an injected clock one probe
      launches K1, closes it and emits every held interval;
    * a fetch fault: the retired group's collect raises (wrapped here
      only) while the next interval's shifted samples arrive in the live
      store, as ingest goes on during a flush; the retired interval
      re-merges, where its import drain trips the guard (K2, held to its
      plain version), and emits at the next flush with every count
      conserved.

    The twin flushes before the launch counts reset: it is the
    reference. Returns (the subphase record, its launch counts)."""
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.resilience.compute import (KERNEL_TDIGEST,
                                                     ComputeBreaker)
    from veneur_tpu_torch.resilience.faults import FaultInjector
    from veneur_tpu_torch.samplers.parser import MetricKey

    rng = np.random.default_rng(SEED + 10)
    interval1 = rng.gamma(2.0, 10.0, (rows, 8)).astype(np.float32)
    shifted = (5000.0 + rng.gamma(2.0, 10.0, (rows, 8))).astype(np.float32)

    def feed(target, vals):
        with target._lock:
            hist = target.histograms
            if not len(hist):
                for i in range(rows):
                    hist.interner.intern(
                        MetricKey(f"cl.h.{i}", "histogram", ""), [])
                hist.ensure_capacity(rows - 1)
            k = vals.shape[1]
            hist.sample_many(np.repeat(np.arange(rows, dtype=np.int32), k),
                             vals.reshape(-1), np.ones(vals.size,
                                                       np.float32))
            hist._drain_samples()

    def flush(target):
        t0 = time.perf_counter()
        col, _ = target.flush(list(PERCENTILES), aggs, 0, columnar=True)
        _sync(dev)
        return col.blocks, time.perf_counter() - t0

    def count_col(blocks):
        blk = blocks[0]
        col_of = {sx.decode(): i for i, sx in enumerate(blk.suffixes)}
        return _block_matrix(blk)[:, col_of[".count"]]

    def is_open(breaker):
        return any(gauge for _, gauge in breaker.states())

    rec = {"histogram_series": rows}
    twin = MetricStore(initial_capacity=1024, device=dev)
    feed(twin, interval1)
    (blk1,), rec["twin_flush_s"] = flush(twin)
    kern = _block_matrix(blk1)
    del twin
    gc.collect()

    now = [1000.0]
    breaker = ComputeBreaker(failure_threshold=2, reset_timeout=60.0,
                             clock=lambda: now[0])
    store = MetricStore(initial_capacity=1024, device=dev, compute=breaker)
    # this store fails on purpose: the phase's no-fallback check covers
    # every other store it builds
    _BREAKERS.remove(breaker)

    def arm():
        breaker.injector = FaultInjector(rate=1.0, seed=SEED,
                                         kinds=("connect",),
                                         scope=KERNEL_TDIGEST)

    _reset_counts(tc)
    # a kernel fault at preflight: no launch, the re-merge, then the
    # late emission held to the twin
    feed(store, interval1)
    arm()
    blocks, rec["faulted_flush_s"] = flush(store)
    if (blocks or tc.drain_quantile.launches or breaker.requeued_total != 1
            or breaker.injector.calls != 1 or is_open(breaker)):
        raise AssertionError(f"kernel fault: blocks {len(blocks)}, K1 "
                             f"{tc.drain_quantile.launches}x, "
                             f"{breaker.snapshot()}")
    breaker.injector = None
    with _capture_launches(tc, "launch_drain_quantile") as k1_calls:
        (blk2,), rec["late_flush_s"] = flush(store)
    if dev.type == "cuda":
        if len(k1_calls) != 1:
            raise AssertionError(f"the late flush launched K1 "
                                 f"{len(k1_calls)}x")
        rec["k1_late_max_abs_err"] = _hold_to_plain(
            tc, "K1 at the late flush", k1_calls[0])
    del k1_calls
    late = _block_matrix(blk2)
    if (blk1.suffixes != blk2.suffixes or blk1.names[0] != blk2.names[0]
            or not all(np.array_equal(x, y) for x, y in
                       zip(blk1.names[1:], blk2.names[1:]))):
        raise AssertionError("the late flush emitted other rows than the "
                             "twin")
    col_of = {sx.decode(): i for i, sx in enumerate(blk1.suffixes)}
    exact = [col_of[sx] for sx in (".count", ".min", ".max")]
    if not np.array_equal(late[:, exact], kern[:, exact]):
        raise AssertionError("the late count/min/max differ from the twin")
    rel = np.abs(late[:, col_of[".sum"]] / kern[:, col_of[".sum"]] - 1.0)
    rec["late_rel_err_sum"] = float(rel.max())
    span = kern[:, col_of[".max"]] - kern[:, col_of[".min"]]
    pc = [i for sx, i in col_of.items() if sx.endswith("percentile")]
    err = np.abs(late[:, pc] - kern[:, pc])
    rec["late_pct_err_of_span"] = float(np.max(err / span[:, None]))
    if rec["late_rel_err_sum"] > 1e-6 or (err > 0.02 * span[:, None]).any():
        raise AssertionError(f"the late interval is off the twin: sum "
                             f"{rec['late_rel_err_sum']:.3g}, percentiles "
                             f"{rec['late_pct_err_of_span']:.3g} of span")
    del blk1, blk2, kern, late
    gc.collect()

    # the breaker: two faults open it; an open breaker re-merges without
    # a launch while the staging drains go on through K2
    arm()
    for _ in range(2):
        feed(store, interval1)
        blocks, _ = flush(store)
        if blocks:
            raise AssertionError("a faulted flush emitted its digests")
    if not is_open(breaker) or breaker.requeued_total != 3:
        raise AssertionError(f"the breaker did not open after 2 faults: "
                             f"{breaker.snapshot()}")
    k1, k2 = tc.drain_quantile.launches, tc.compress_presorted.launches
    calls = breaker.injector.calls
    feed(store, interval1)
    feed(store, shifted)
    rec["open_breaker_k2"] = tc.compress_presorted.launches - k2
    blocks, _ = flush(store)
    if (blocks or tc.drain_quantile.launches != k1
            or breaker.injector.calls != calls
            or breaker.requeued_total != 4
            or (dev.type == "cuda" and not rec["open_breaker_k2"])):
        raise AssertionError(f"open breaker: K1 launched, the probe spent, "
                             f"or the drains left K2: {rec}, "
                             f"{breaker.snapshot()}")
    breaker.injector = None
    now[0] += 61.0
    feed(store, interval1)
    blocks, rec["probe_flush_s"] = flush(store)
    held = count_col(blocks)
    if is_open(breaker) or (dev.type == "cuda"
                            and tc.drain_quantile.launches != k1 + 1):
        raise AssertionError("the half-open probe did not close the "
                             "breaker through K1")
    if not (held == 40).all():   # 2 faulted, 2 open, 1 probe interval
        raise AssertionError(f"the held intervals lost counts: "
                             f"{held.sum()} != {rows * 40}")

    # a fetch fault while the next interval arrives
    feed(store, interval1)
    retired = store.histograms
    attempts = []

    def failing_collect(*args):
        attempts.append(len(attempts))
        feed(store, shifted)    # ingest goes on during the flush
        raise RuntimeError("collect failed (smoke script)")

    retired._flush_collect = failing_collect
    k2 = tc.compress_presorted.launches
    with _capture_launches(tc, "launch_compress_presorted") as k2_calls:
        blocks, _ = flush(store)
    del retired
    if blocks or breaker.requeued_total != 5 or breaker.lost_total \
            or attempts != [0]:
        raise AssertionError(f"fetch fault: {breaker.snapshot()}, "
                             f"attempts {attempts}")
    rec["remerge_k2"] = tc.compress_presorted.launches - k2
    if dev.type == "cuda":
        if not k2_calls:
            raise AssertionError("the re-merge did not trip the guard")
        rec["k2_remerge_max_abs_err"] = _hold_to_plain(
            tc, "K2 at the re-merge", k2_calls[0])
    del k2_calls
    blocks, _ = flush(store)
    cnt = count_col(blocks)
    if float(cnt.sum()) != rows * 16 or not (cnt == 16).all():
        raise AssertionError(f"the re-merge lost counts: {cnt.sum()} != "
                             f"{rows * 16}")
    rec.update(requeued_total=breaker.requeued_total,
               lost_total=breaker.lost_total)
    return rec, _counts(tc)


def phase_checkpoint(dev, card: str, rows: int = CKPT_ROWS,
                     set_series: int = SET_SERIES,
                     scalars: int = CKPT_SCALARS, topk: int = CKPT_TOPK,
                     ladder_rows: int = LADDER_ROWS) -> dict:
    """Crash-safe state on the card: the kill and warm restart
    (run_checkpoint), then the compute_ladder subphase. Prints one line
    each; returns the launch counts of both main paths."""
    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    t0 = time.perf_counter()
    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    t = _checkpoint_traffic(rows, set_series, scalars, topk)
    rec, counts = run_checkpoint(dev, t, aggs)
    emit({"phase": "checkpoint", "card": card, "histogram_series": rows,
          "set_series": set_series, "scalars": scalars,
          "topk_series": topk, "launches": counts, **rec,
          "phase_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    lad, lcounts = run_compute_ladder(dev, aggs, ladder_rows)
    emit({"phase": "compute_ladder", "card": card, "launches": lcounts,
          **lad, "phase_s": time.perf_counter() - t0})
    return {k: counts[k] + lcounts[k] for k in counts}


# ---------------------------------------------------------------------------
# capacity: the slab and tiered digest stores at the JAX package's own
# capacity-plan sizes (bench.py lanes 2_histo_4m, 2b_histo_10m_bf16,
# 2c_merge_global_10m, 2g_tiered_10m; their sizes copied here as data)
# ---------------------------------------------------------------------------

CAP_ITERS = 2                    # timed staging/flush rounds a subphase
#                                  (3 until the sinks phase came)
                                 # (5 until the fleet_ha phase came)
CAP_ORACLE_ROWS = 2048           # the dense oracle's sampled rows
CAP_SERIES = 1 << 14             # the Servers' histogram series (65,536
#                                  until the sinks phase, 32,768 until the
#                                  lifecycle phase came)
CAP_AUX_SERIES = 1 << 14         # the checkpoint's and the ladder's
CAP_HOT = 1024                   # hot series among them (40 more samples)
CAP_ENVELOPE = 0.15              # bench.py 2g's excess rank error gate


class _RangeInterner:
    """Interner stand-in for the 10M-series tiered group (bench.py's
    _RangeInterner): 10M MetricKeys are GBs of Python objects, and the
    flush reads only its length and the hot rows' name and tags."""

    class _Names:
        def __getitem__(self, i):
            return f"s{i}"

    class _Joined:
        def __getitem__(self, i):
            return ""

    def __init__(self, n: int):
        self._n = n
        self.rows = {}
        self.names = self._Names()
        self.joined = self._Joined()

    def __len__(self):
        return self._n


class _first_launch:
    """Within the block, keep the arguments and outputs of the FIRST
    launch of ``tc.<name>`` only (a slab flush launches tens of times
    at hundreds of MB each), to hold it against its plain version; with
    ``kernel_name``, on the card, also the device function it ran
    (``last_kernel_name``, read right after it)."""

    def __init__(self, tc, name: str, kernel_name: bool = False):
        self.tc, self.name = tc, name
        self.real = getattr(tc, name)
        self.call = self.kernel = None
        self.kernel_name = kernel_name

    def __enter__(self):
        def launch(*args):
            out = self.real(*args)
            if self.call is None:
                self.call = (args, out)
                if self.kernel_name and args[0].is_cuda:
                    self.kernel = self.tc.last_kernel_name()
            return out

        setattr(self.tc, self.name, launch)
        return self

    def __exit__(self, *exc):
        setattr(self.tc, self.name, self.real)


def _peak_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.zeros(1, device=dev)   # the allocator exists before a reset
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_bytes(dev):
    import torch

    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def _add_counts(total: dict, counts: dict) -> dict:
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n
    return total


def _rank_errors(pcts, oracle_pcts, samples) -> tuple:
    """bench.py 2g's merged_ok measure over sampled rows: the largest
    rank error of a percentile against the row's exact samples, and the
    largest EXCESS over the dense oracle's own (the reference's quantile
    interpolation costs both alike on a few-sample row)."""
    worst = excess = 0.0
    for m, vals in enumerate(samples):
        t = np.sort(np.asarray(vals, np.float64))
        if not len(t):
            continue
        for qi, q in enumerate(PERCENTILES):
            errs = []
            for v in (float(pcts[m, qi]), float(oracle_pcts[m, qi])):
                lo = np.searchsorted(t, v, "left") / len(t)
                hi = np.searchsorted(t, v, "right") / len(t)
                errs.append(max(0.0, lo - q, q - hi))
            worst = max(worst, errs[0])
            excess = max(excess, errs[0] - errs[1])
    return worst, excess


def _dense_oracle(dev, rounds, centroids: bool = False):
    """A dense DigestGroup on ``dev`` fed the sampled rows identically:
    ``rounds`` is [rows, rounds] (NaN = no value that round), each round
    staged and drained on its own, as the store under test took it (one
    value a row a chunk), or with ``centroids`` the one round imported
    as unit centroids with each row's extrema (the merge role's
    import). Returns (percentiles [n, P], counts [n])."""
    from veneur_tpu_torch.core.bucketing import next_pow2
    from veneur_tpu_torch.core.store import DigestGroup
    from veneur_tpu_torch.samplers.parser import MetricKey

    n = len(rounds)
    g = DigestGroup(capacity=next_pow2(n), chunk=1 << 16, device=dev)
    for i in range(n):
        g.interner.intern(MetricKey(f"o{i}", "histogram", ""), [])
    if centroids:
        rows = np.repeat(np.arange(n, dtype=np.int32), rounds.shape[1])
        vals = rounds.reshape(-1).astype(np.float32)
        g.import_centroids_bulk(
            rows, vals, np.ones(len(vals), np.float32),
            np.arange(n, dtype=np.int32), rounds.min(1).astype(np.float32),
            rounds.max(1).astype(np.float32))
    else:
        for col in rounds.T:
            rows = np.flatnonzero(~np.isnan(col)).astype(np.int32)
            g.sample_many(rows, col[rows].astype(np.float32),
                          np.ones(len(rows), np.float32))
            g._drain_samples()
    _, r = g.flush(list(PERCENTILES), want_digests=False,
                   want_stats=("pcts", "count"))
    return r["percentiles"], r["count"]


def _timed(dev, fn) -> float:
    _sync(dev)
    t = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t


def _oracle_check(name, pcts, counts, samples, opcts, ocounts) -> dict:
    """The sampled rows against the dense oracle: counts exact (an
    importing oracle has none: ``ocounts`` None), the excess rank error
    inside bench.py 2g's envelope."""
    worst, excess = _rank_errors(pcts, opcts, samples)
    rec = {"oracle_rows": len(samples), "rank_err": worst,
           "excess_rank_err": excess,
           "oracle_counts_equal": ocounts is None
           or bool(np.array_equal(counts, ocounts))}
    if not rec["oracle_counts_equal"] or excess > CAP_ENVELOPE:
        raise AssertionError(f"{name}: the sampled rows left the dense "
                             f"oracle's envelope: {rec}")
    return rec


def run_slab_bank(dev, label: str, series: int, dtype: str, slab_rows: int,
                  chunks: int, iters: int = CAP_ITERS) -> tuple:
    """A local-role SlabDigestBank at ``series`` (bench.py
    bench_histo_flush): every slab takes ``chunks`` chunks of one
    gamma(2, 50) sample a row, staged untimed in bench.py and timed here
    apart; the flush drains each slab through K1 (the digests upcast
    from ``dtype``). The first flush is fetched and checked (every count
    exact, the sampled rows against a dense oracle) with its first K1
    launch held to the plain version; then ``iters`` rounds of staging
    and flush, each timed to a device sync (the flush without the host
    fetch, as bench.py times it). Returns (record, launch counts)."""
    import torch

    from veneur_tpu_torch.core.slab import SlabDigestBank
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    _peak_reset(dev)
    bank = SlabDigestBank(series, COMPRESSION, slab_rows=slab_rows,
                          digest_dtype=dtype, device=dev)
    nslabs, slab = bank.num_slabs, bank.slab_rows
    rng = np.random.default_rng(SEED + 40)
    perm = rng.permutation(slab)
    inv = np.argsort(perm)
    valsets = [rng.gamma(2.0, 50.0, slab).astype(np.float32)
               for _ in range(4)]
    rows_d = torch.from_numpy(perm.astype(np.int64)).to(dev)
    vals_d = [torch.from_numpy(v).to(dev) for v in valsets]
    wts = torch.ones(slab, dtype=torch.float32, device=dev)

    def stage():
        for i in range(nslabs):
            for j in range(chunks):
                bank.ingest_slab(i, rows_d, vals_d[j % 4], wts)

    qs = list(PERCENTILES)
    _reset_counts(tc)
    rec = {"series": series, "dtype": dtype, "slab_rows": slab,
           "slabs": nslabs, "chunks": chunks,
           "resident_gb": bank.hbm_bytes()["total_bytes"] / 2**30}
    rec["first_staging_s"] = _timed(dev, stage)
    with _first_launch(tc, "launch_drain_quantile") as cap:
        t = time.perf_counter()
        out = bank.flush(qs)
        rec["first_flush_fetched_s"] = time.perf_counter() - t
    counts = _counts(tc)
    args = cap.call[0]
    rec["k1_input_dtype"] = str(args[0].dtype)
    rec["k1_rows"] = int(args[0].shape[0])
    rec["k1_max_abs_err"] = _hold_to_plain(tc, f"{label} K1", cap.call)
    del cap
    rec["counts_exact"] = bool((out["count"] == float(chunks)).all())
    osel = np.unique(rng.choice(series, CAP_ORACLE_ROWS, replace=False))
    local = inv[osel % slab]
    rounds = np.stack([valsets[j % 4][local] for j in range(chunks)], 1)
    samples = list(rounds)
    opcts, ocounts = _dense_oracle(dev, rounds)
    rec.update(_oracle_check(label, out["percentiles"][osel],
                             out["count"][osel], samples, opcts, ocounts))
    del out
    _reset_counts(tc)
    stage_s, flush_s = [], []
    for _ in range(iters):
        stage_s.append(_timed(dev, stage))
        flush_s.append(_timed(dev, lambda: bank.flush(qs, fetch=False)))
    counts = _add_counts(counts, _counts(tc))
    rec.update(staging_s=float(np.median(stage_s)),
               flush_s=float(np.median(flush_s)), staging_all_s=stage_s,
               flush_all_s=flush_s, peak_bytes=_peak_bytes(dev),
               launches=counts)
    if not rec["counts_exact"] or counts["drain_quantile.launches"] != \
            nslabs * (iters + 1):
        raise AssertionError(f"{label}: {rec}")
    del bank
    return rec, counts


def run_merge_bank(dev, series: int, dtype: str,
                   iters: int = CAP_ITERS) -> tuple:
    """A merge-role SlabDigestBank at ``series`` (bench.py
    bench_merge_global): one forwarded batch of sorted [slab, K]
    unit-weight centroids merged into every slab through K2 (merge width
    256, the digests upcast from ``dtype``), then the flush
    (``quantile`` a slab, no kernel). The first round is checked (every
    count exact from the float32 count plane, the sampled rows against a
    dense oracle that imports the same centroids) with its first K2
    launch held to the plain version; then ``iters`` timed rounds."""
    import torch

    from veneur_tpu_torch.core.slab import SlabDigestBank
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    _peak_reset(dev)
    bank = SlabDigestBank(series, COMPRESSION, digest_dtype=dtype,
                          mode="merge", device=dev)
    nslabs, slab, k = bank.num_slabs, bank.slab_rows, bank.k
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    # gamma(2, 40) as the sum of two exponentials, on the device
    base = sum(torch.empty((slab, k), device=dev).exponential_(
        1.0 / 40.0, generator=gen) for _ in range(2))
    base = torch.sort(base, dim=1).values
    w_in = torch.ones_like(base)
    mins, maxs = base[:, 0].contiguous(), base[:, -1].contiguous()

    def merge_batch():
        for i in range(nslabs):
            bank.merge_digests(i, base, w_in, mins, maxs)

    qs = list(PERCENTILES)
    _reset_counts(tc)
    rec = {"series": series, "dtype": dtype, "slab_rows": slab,
           "slabs": nslabs, "merge_width": 2 * 128,
           "resident_gb": bank.hbm_bytes()["total_bytes"] / 2**30}
    with _first_launch(tc, "launch_compress_presorted") as cap:
        rec["first_merge_s"] = _timed(dev, merge_batch)
    t = time.perf_counter()
    out = bank.flush(qs)
    rec["first_flush_fetched_s"] = time.perf_counter() - t
    counts = _counts(tc)
    rec["k2_input_dtype"] = str(cap.call[0][0].dtype)
    rec["k2_rows"] = int(cap.call[0][0].shape[0])
    rec["k2_max_abs_err"] = _hold_to_plain(tc, "merge K2", cap.call)
    del cap
    rec["counts_exact"] = bool((out["count"] == float(k)).all())
    rng = np.random.default_rng(SEED + 42)
    osel = np.unique(rng.choice(series, CAP_ORACLE_ROWS, replace=False))
    host = base[torch.from_numpy(osel % slab).to(dev)].cpu().numpy()
    samples = list(host)
    opcts, _ = _dense_oracle(dev, host, centroids=True)
    rec.update(_oracle_check("merge_10m_bf16", out["percentiles"][osel],
                             out["count"][osel], samples, opcts, None))
    del out
    _reset_counts(tc)
    merge_s, flush_s = [], []
    for _ in range(iters):
        merge_s.append(_timed(dev, merge_batch))
        flush_s.append(_timed(dev, lambda: bank.flush(qs, fetch=False)))
    counts = _add_counts(counts, _counts(tc))
    rec.update(merge_s=float(np.median(merge_s)),
               flush_s=float(np.median(flush_s)), merge_all_s=merge_s,
               flush_all_s=flush_s, peak_bytes=_peak_bytes(dev),
               launches=counts)
    if not rec["counts_exact"] or counts["compress_presorted.launches"] != \
            nslabs * (iters + 1):
        raise AssertionError(f"merge_10m_bf16: {rec}")
    del bank, base, w_in
    return rec, counts


def run_tiered_group(dev, series: int, hot_rows: int = 10000,
                     cold_samples: int = 4, hot_rounds: int = 40,
                     iters: int = CAP_ITERS) -> tuple:
    """A TieredDigestGroup at ``series`` (bench.py bench_tiered_10m):
    262,144-row pool slabs, promote_samples 32, promote_intervals 1;
    every series takes ``cold_samples`` rounds of one sample, then
    ``hot_rows`` series take ``hot_rounds`` more (they promote to dense
    slots mid-interval). The first interval is checked (every count
    exact, the sampled rows, cold and hot, against a dense oracle fed
    identically) with the first pool compaction (K2 at merge width 32)
    and the dense bank's K1 held to their plain versions; then ``iters``
    timed rounds of staging and flush."""
    from veneur_tpu_torch.core.tiered import TieredDigestGroup
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    _peak_reset(dev)
    chunk = 1 << 16
    g = TieredDigestGroup(slab_rows=1 << 18, chunk=chunk,
                          promote_samples=32, promote_intervals=1,
                          device=dev)
    g.ensure_capacity(series - 1)
    g.interner = _RangeInterner(series)
    rng = np.random.default_rng(SEED + 43)
    hot = rng.choice(series, size=min(hot_rows, series),
                     replace=False).astype(np.int64)
    osel = np.unique(np.concatenate([
        rng.choice(series, CAP_ORACLE_ROWS - 64, replace=False),
        hot[:64]]).astype(np.int64))
    ones = np.ones(chunk, np.float32)
    # each sampled row's index among the hot rows (-1: cold)
    hot_at = np.full(len(osel), -1, np.int64)
    where = np.searchsorted(np.sort(hot), osel)
    is_hot = np.isin(osel, hot)
    hot_at[is_hot] = np.argsort(hot)[where[is_hot]]

    def stage(record=None):
        for _ in range(cold_samples):
            vals = rng.gamma(2.0, 50.0, series).astype(np.float32)
            for start in range(0, series, chunk):
                n = min(chunk, series - start)
                g.sample_many(np.arange(start, start + n, dtype=np.int64),
                              vals[start:start + n], ones[:n])
            if record is not None:
                record.append(vals[osel])
        for _ in range(hot_rounds):
            vals = rng.gamma(2.0, 50.0, len(hot)).astype(np.float32)
            g.sample_many(hot, vals, ones[:len(hot)])
            if record is not None:
                record.append(np.where(hot_at >= 0,
                                       vals[np.maximum(hot_at, 0)], np.nan))

    def flush(**kw):
        _, r = g.flush(list(PERCENTILES), want_digests=False,
                       want_stats=("pcts", "count"), **kw)
        ni = _RangeInterner(series)
        g.interner = ni
        # the range interner bypasses _row, which gives a directory-dense
        # series its dense slot at first sight: re-stamp the hot rows
        for row in hot:
            if g.directory.is_dense((ni.names[int(row)],
                                     ni.joined[int(row)])):
                g._assign_dense(int(row))
        return r

    _reset_counts(tc)
    record = []
    rec = {"series": series, "hot_rows": int(len(hot)),
           "cold_samples": cold_samples, "pool_slab_rows": g.slab_rows,
           "pool_centroids": g.pk}
    rec["first_staging_s"] = _timed(dev, lambda: stage(record))
    rec["dense_rows_first"] = len(g._dense_rows)
    with _first_launch(tc, "launch_compress_presorted") as k2, \
            _first_launch(tc, "launch_drain_quantile") as k1:
        t = time.perf_counter()
        r0 = flush()
        rec["first_flush_s"] = time.perf_counter() - t
    counts = _counts(tc)
    a = k2.call[0]
    rec["k2_merge_width"] = 2 * tc.next_pow2(max(a[0].shape[1],
                                                 a[2].shape[1]))
    rec["k2_rows"] = int(a[0].shape[0])
    rec["k2_max_abs_err"] = _hold_to_plain(tc, "pool compact K2", k2.call)
    rec["k1_rows"] = int(k1.call[0][0].shape[0])
    rec["k1_max_abs_err"] = _hold_to_plain(tc, "dense bank K1", k1.call)
    if dev.type == "cuda":
        # the compaction's full call timed on its own inputs, beside its
        # bound (after the counts are read: not the main path's launches)
        nbytes, ops = _work(rec["k2_rows"], a[0].shape[1], a[2].shape[1],
                            a[5], 0, False, False)
        rec["k2_w32_ms"] = _median_ms(lambda: tc.compress_presorted(*a),
                                      TIMED_LAUNCHES)
        rec["k2_w32_plain_ms"] = _median_ms(
            lambda: tc.compress_presorted_plain(*a), PLAIN_RUNS, warmup=1)
        rec["k2_w32_bound_ms"], rec["k2_w32_bound_by"] = _bound(nbytes, ops)
        rec["k2_w32_bytes"], rec["k2_w32_ops"] = nbytes, ops
        # the compaction's kernel, as the launcher names it (a profiler
        # trace this late in the script was seen to hold no device events)
        rec["k2_w32_device_kernel"] = tc.last_kernel_name()
        if "narrow_rows_kernel" not in rec["k2_w32_device_kernel"] or \
                counts["compress_presorted.narrow32_launches"] < 1:
            raise AssertionError(f"tiered_10m: the compaction ran "
                                 f"{rec['k2_w32_device_kernel']!r}; {counts}")
        _RECORDS["pool_k2_w32"] = {
            "max_abs_err": rec["k2_max_abs_err"],
            **{f: rec[f"k2_w32_{f}"] for f in ("ms", "plain_ms", "bound_ms",
                                                "bound_by")}}
    del k1, k2, a
    want = np.full(series, float(cold_samples), np.float32)
    want[hot] += hot_rounds
    rec["counts_exact"] = bool(np.array_equal(r0["count"], want))
    vals = np.stack(record, axis=1)
    samples = [v[~np.isnan(v)] for v in vals]
    opcts, ocounts = _dense_oracle(dev, vals)
    rec.update(_oracle_check("tiered_10m", r0["percentiles"][osel],
                             r0["count"][osel], samples, opcts, ocounts))
    del r0
    _reset_counts(tc)
    stage_s, flush_s = [], []
    for _ in range(iters):
        stage_s.append(_timed(dev, stage))
        flush_s.append(_timed(dev, flush))
    counts = _add_counts(counts, _counts(tc))
    plan = g.hbm_bytes()
    rec.update(staging_s=float(np.median(stage_s)),
               flush_s=float(np.median(flush_s)), staging_all_s=stage_s,
               flush_all_s=flush_s, promotions=g.directory.promotions,
               resident_gb=plan["total_bytes"] / 2**30,
               pool_bytes_per_row=plan["pool_bytes_per_row"],
               peak_bytes=_peak_bytes(dev), launches=counts)
    if not rec["counts_exact"] or rec["k2_merge_width"] != 32:
        raise AssertionError(f"tiered_10m: {rec}")
    del g
    return rec, counts


def _cap_lines(series: int, hot: int, seed: int):
    """``series`` histogram series x 8 samples, the first ``hot`` 40 more
    (4 decimals, exact as the parser reads them); returns (lines in a
    seeded order, samples by series name)."""
    rng = np.random.default_rng(seed)
    lines, samples = [], {}
    for i in range(series):
        vals = np.round(rng.gamma(2.0, 10.0, 48 if i < hot else 8), 4)
        samples[f"cap.h.{i}"] = vals.astype(np.float32)
        lines += [f"cap.h.{i}:{v:.4f}|h" for v in vals.tolist()]
    order = rng.permutation(len(lines))
    return [lines[j] for j in order], samples


def _pct_rows(rows: dict) -> dict:
    """(series name, q) -> value of the percentile rows."""
    out = {}
    for (name, _), v in rows.items():
        base, _, suffix = name.rpartition(".")
        if suffix.endswith("percentile"):
            out[base, float(suffix[:-len("percentile")]) / 100.0] = v
    return out


def _hold_rows(label: str, got: dict, want: dict, samples: dict,
               span_tol) -> dict:
    """A storage's rows against the dense twin's: every row present,
    count/min/max exact, sum rel 1e-6; percentiles within ``span_tol`` x
    (max - min), or with ``span_tol`` None by the rank error they add
    over the twin's: at most bench.py 2g's 0.15, or two samples' rank on
    a row of few samples (a pool bin with no room between its brackets
    takes the nearer one, so two neighbouring samples may share a
    centroid: bin_pool_samples, which bins as the JAX package's does,
    tests/test_torch_tiered.py; seen at 65,536 series on the CPU, 7-9
    percentile rows of 524,288 at 2/8)."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: rows differ from the dense twin")
    bad = []
    for (name, tags), v in want.items():
        suffix = name.rpartition(".")[2]
        g = got[(name, tags)]
        if suffix in ("count", "min", "max") and g != v:
            bad.append(name)
        elif suffix == "sum" and abs(g - v) > 1e-6 * abs(v) + 1e-6:
            bad.append(name)
    gp, wp = _pct_rows(got), _pct_rows(want)
    keys = list(wp)
    by_len = {}
    for k, (base, _) in enumerate(keys):
        by_len.setdefault(len(samples[base]), []).append(k)
    worst = 0.0
    for n, sel in by_len.items():
        # the rows of one sample count at once: [m, n] sorted samples
        t = np.sort(np.stack([samples[keys[k][0]] for k in sel])
                    .astype(np.float64), axis=1)
        q = np.array([keys[k][1] for k in sel])
        g = np.array([gp[keys[k]] for k in sel], np.float64)
        w = np.array([wp[keys[k]] for k in sel], np.float64)
        if span_tol is not None:
            err = np.abs(g - w) / np.maximum(t[:, -1] - t[:, 0], 1e-30)
            over = err > span_tol
        else:
            def rank_err(v):
                lo = (t < v[:, None]).sum(1) / n
                hi = (t <= v[:, None]).sum(1) / n
                return np.maximum(0.0, np.maximum(lo - q, q - hi))

            err = rank_err(g) - rank_err(w)
            over = err > max(CAP_ENVELOPE, 2.0 / n)
        worst = max(worst, float(err.max()))
        bad += [keys[sel[k]][0] for k in np.flatnonzero(over)]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} rows off the dense "
                             f"twin, e.g. {bad[:5]}")
    return {"rows": len(want), ("pct_span_err" if span_tol is not None
                                else "excess_rank_err"): worst}


def run_capacity_servers(dev, series: int = CAP_SERIES,
                         hot: int = CAP_HOT) -> tuple:
    """Three port Servers, each through the default UDP lane (4 lanes):
    ``digest_storage`` dense (the twin), slab with bfloat16 digests, and
    tiered (promote_samples 32, promote_intervals 1, so the hot series
    promote); ``series`` histogram series x 8 samples, the first ``hot``
    x 48, the same datagrams to each. Each flushes columnar into a
    recording sink; the slab and tiered rows are held to the twin's. The
    groups start at their final capacity, so the dense twin never grows
    (a growth drains its staging, the pinned difference of ROADMAP
    section 3)."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server

    lines, samples = _cap_lines(series, hot, SEED + 44)
    packed = _pack_lines(lines)
    dgrams = _datagrams(packed)
    cum = np.concatenate([[0], np.cumsum(packed["d_lines"])])
    configs = {
        "dense": {},
        "slab_bf16": {"digest_storage": "slab",
                      "digest_dtype": "bfloat16"},
        "tiered": {"digest_storage": "tiered", "tier_promote_samples": 32,
                   "tier_promote_intervals": 1}}
    rows, recs, counts = {}, {}, {}
    for name, extra in configs.items():
        sink = _ColumnarRecorder()
        server = Server(Config(
            statsd_listen_addresses=["udp://127.0.0.1:0"], num_readers=4,
            interval="86400s", percentiles=list(PERCENTILES),
            aggregates=["min", "max", "count", "sum"], hostname="smoke",
            store_initial_capacity=series, **extra),
            metric_sinks=[sink], device=dev)
        server.start()
        rec = {}
        try:
            fleet = server.ingest_fleets[0]
            port = fleet.bound[0][1]
            _reset_counts(tc)
            t0 = time.perf_counter()
            _udp_send(port, dgrams,
                      lambda n: fleet.totals()["merged"] >= cum[n])
            rec["ingest_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            server.flush()
            batch = sink.flushes.get(timeout=120)
            rec["flush_s"] = time.perf_counter() - t0
            _add_counts(counts, _counts(tc))
            rec["launches"] = _counts(tc)
            rec["kernel_drops"] = _udp_drops(port)
            g = server.store.histograms
            if name == "tiered":
                rec["promotions"] = g.directory.promotions
        finally:
            server.shutdown()
        rows[name] = {(m.name, tuple(m.tags)): m.value
                      for m in batch.to_intermetrics()
                      if m.name.startswith("cap.h.")}
        recs[name] = rec
    recs["slab_bf16"].update(_hold_rows("slab_bf16 Server", rows["slab_bf16"],
                                        rows["dense"], samples, 0.02))
    recs["tiered"].update(_hold_rows("tiered Server", rows["tiered"],
                                     rows["dense"], samples, None))
    if len(rows["dense"]) != series * (4 + len(PERCENTILES)) or \
            recs["tiered"]["promotions"] < hot:
        raise AssertionError(f"capacity servers: {recs}")
    return {"series": series, "hot": hot, "lines": len(lines),
            "datagrams": len(dgrams), **recs}, counts


def _fed_store(dev, storage: str, samples: dict, **kw):
    """A port MetricStore of ``storage`` on ``dev``, its histogram group
    fed ``samples`` (name -> values) through the store API: each series
    interned, then every sample in one seeded order by sample_many."""
    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.samplers.parser import MetricKey

    store = MetricStore(initial_capacity=max(len(samples), 1024),
                        chunk=1 << 14, digest_storage=storage, device=dev,
                        **kw)
    if not samples:
        return store
    hist = store.histograms
    with store._lock:
        rows = np.array([hist._row(MetricKey(name, "histogram", ""), [])
                         for name in samples], np.int32)
        lens = [len(v) for v in samples.values()]
        rows = np.repeat(rows, lens)
        vals = np.concatenate(list(samples.values())).astype(np.float32)
        order = np.random.default_rng(SEED + 47).permutation(len(vals))
        hist.sample_many(rows[order], vals[order],
                         np.ones(len(vals), np.float32))
    return store


def _store_rows(store, aggs) -> dict:
    flushed, _ = store.flush(list(PERCENTILES), aggs, 0, columnar=True)
    return {(m.name, tuple(m.tags)): m.value
            for m in flushed.to_intermetrics()}


def run_capacity_checkpoint(dev, aggs,
                            series: int = CAP_AUX_SERIES) -> tuple:
    """A checkpoint written by a slab store (bfloat16 digests) and
    restored into a tiered one: the VCKP file to local disk and back,
    restore_state into the tiered store, a columnar flush held to the
    slab store's own flush of the same interval."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.persist import (deserialize, read_file,
                                          serialize, write_atomic)

    _, samples = _cap_lines(series, CAP_HOT, SEED + 45)
    src = _fed_store(dev, "slab", samples, digest_dtype="bfloat16")
    _reset_counts(tc)
    t0 = time.perf_counter()
    groups, _ = src.snapshot_state()
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "capacity.ckpt")
    write_atomic(path, serialize(groups, created_at=time.time(),
                                 interval=10.0))
    rec = {"series": series, "write_s": time.perf_counter() - t0,
           "bytes": os.path.getsize(path)}
    dst = _fed_store(dev, "tiered", {}, tier_promote_samples=32,
                     tier_promote_intervals=1)
    t0 = time.perf_counter()
    restored = dst.restore_state(deserialize(read_file(path))[0])
    rec["restore_s"] = time.perf_counter() - t0
    rec["restored_series"] = restored
    got = _store_rows(dst, aggs)
    counts = _counts(tc)
    want = _store_rows(src, aggs)
    os.remove(path)
    got = {k: v for k, v in got.items() if k[0].startswith("cap.h.")}
    want = {k: v for k, v in want.items() if k[0].startswith("cap.h.")}
    rec.update(_hold_rows("slab -> tiered restore", got, want, samples,
                          None))
    rec["launches"] = counts
    return rec, counts


def run_capacity_ladder(dev, aggs, series: int = CAP_AUX_SERIES) -> tuple:
    """Rung 3 on a slab and a tiered store: a FaultInjector fails the
    flush kernel at preflight, the interval re-merges into the live
    group (requeued_total 1) and emits at the next flush, held to a twin
    store that never failed. These two stores are the phase's only ones
    allowed to requeue."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.resilience.faults import FaultInjector

    _, samples = _cap_lines(series, CAP_HOT, SEED + 46)
    recs, counts = {}, {}
    for storage, kw in (("slab", {"digest_dtype": "bfloat16"}),
                        ("tiered", {"tier_promote_samples": 32,
                                    "tier_promote_intervals": 1})):
        store = _fed_store(dev, storage, samples, **kw)
        twin = _fed_store(dev, storage, samples, **kw)
        if store.compute in _BREAKERS:
            _BREAKERS.remove(store.compute)
        store.compute.injector = FaultInjector(
            rate=1.0, seed=SEED, kinds=("connect",),
            scope="compute.tdigest_merge")
        _reset_counts(tc)
        t0 = time.perf_counter()
        faulted = _store_rows(store, aggs)
        rec = {"faulted_flush_s": time.perf_counter() - t0}
        store.compute.injector = None
        t0 = time.perf_counter()
        late = _store_rows(store, aggs)
        rec["late_flush_s"] = time.perf_counter() - t0
        _add_counts(counts, _counts(tc))
        rec["launches"] = _counts(tc)
        want = _store_rows(twin, aggs)
        c = store.compute
        rec.update(requeued_total=c.requeued_total, lost_total=c.lost_total)
        if any(k[0].startswith("cap.h.") for k in faulted) or \
                (c.requeued_total, c.lost_total) != (1, 0):
            raise AssertionError(f"{storage} rung 3: {rec}")
        late = {k: v for k, v in late.items() if k[0].startswith("cap.h.")}
        want = {k: v for k, v in want.items() if k[0].startswith("cap.h.")}
        rec.update(_hold_rows(f"{storage} rung 3", late, want, samples,
                              0.02 if storage == "slab" else None))
        recs[storage] = rec
    return recs, counts


def phase_capacity(dev, card: str, slab4m: int = 4 << 20,
                   slab10m: int = 10 << 20, tiered10m: int = 10 << 20,
                   servers: int = CAP_SERIES) -> dict:
    """The slab and tiered digest stores at the JAX package's own
    capacity-plan sizes, one line a subphase, each subphase's state freed
    before the next; returns the phase's launch counts."""
    import torch

    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    counts = {}
    t_phase = time.perf_counter()
    for name, run in (
            ("slab_4m", lambda: run_slab_bank(
                dev, "slab_4m", slab4m, "float32", 1 << 20, 8)),
            ("slab_10m_bf16", lambda: run_slab_bank(
                dev, "slab_10m_bf16", slab10m, "bfloat16", 1 << 18, 4)),
            ("merge_10m_bf16", lambda: run_merge_bank(
                dev, slab10m, "bfloat16")),
            ("tiered_10m", lambda: run_tiered_group(dev, tiered10m)),
            ("servers", lambda: run_capacity_servers(dev, servers)),
            ("checkpoint", lambda: run_capacity_checkpoint(dev, aggs)),
            ("ladder", lambda: run_capacity_ladder(dev, aggs))):
        t0 = time.perf_counter()
        rec, c = run()
        _add_counts(counts, c)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        emit({"phase": "capacity", "subphase": name, "card": card, **rec,
              "subphase_s": time.perf_counter() - t0})
    emit({"phase": "capacity", "card": card, "launches": counts,
          "phase_s": time.perf_counter() - t_phase})
    return counts


# the mesh phase: the mesh-sharded global tier on a 4 x 2 shard mesh

MESH_SERIES = 1 << 20            # the aggregator's and butterfly's series
MESH_HOSTS = 2                   # the hosts axis: 4 x 2 on one card
MESH_SAMPLES = 1 << 24           # the aggregator's samples a host (~32 a row)
MESH_QS = (0.5, 0.9, 0.99)       # the dryrun's quantiles
MESH_SETS = 1 << 20              # its set members a host
MESH_COUNTERS = 1 << 20          # its counter increments a host
MESH_CKPT_ROWS = 1 << 14         # the mesh checkpoint's series (65,536
#                                  until the sinks phase, 32,768 until the
#                                  lifecycle phase came)
MESH_LADDER_ROWS = 1 << 14       # rung 3 on a mesh group


def _shard_mesh(dev):
    """The 4 x 2 mesh on one card: the device eight times."""
    from veneur_tpu_torch.parallel.mesh import fleet_mesh

    return fleet_mesh([dev] * 8, hosts=MESH_HOSTS)


def _grouped_quantiles(rows, vals, qs, keep):
    """np.quantile (linear) of each row's samples, for the rows where
    ``keep`` is true and at least 4 samples fell: returns (rows, [n, P]
    quantiles, spans), vectorized over one lexsort."""
    sel = keep[rows]
    r, v = rows[sel], vals[sel].astype(np.float64)
    order = np.lexsort((v, r))
    r, v = r[order], v[order]
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    counts = np.diff(np.r_[starts, len(r)])
    ok = counts >= 4
    starts, counts = starts[ok], counts[ok]
    pos = np.asarray(qs)[None, :] * (counts[:, None] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, counts[:, None] - 1)
    frac = pos - lo
    a, b = v[starts[:, None] + lo], v[starts[:, None] + hi]
    span = v[starts + counts - 1] - v[starts]
    return r[starts], a + frac * (b - a), span


def run_mesh_aggregator(dev, series: int = MESH_SERIES,
                        samples: int = MESH_SAMPLES, sets: int = MESH_SETS,
                        counters: int = MESH_COUNTERS) -> dict:
    """GlobalAggregator.step at ``series`` on the 4 x 2 mesh with a
    make_host_batch of 2 hosts (~32 samples a row, the dryrun's density):
    counters exact against np.add.at, the registers bit for bit one
    device's scatter-max, the digest mass exact, and the dryrun's
    quantiles of every 5th row against np.quantile. The dryrun holds
    each of its few rows within 0.15 of the span; over 200k rows the
    digest's q*n interpolation against np.quantile's q*(n-1) puts a tail
    of rows past it at ~32 samples (either package), so the 99th
    percentile of the rows' error is held to 0.15 and the maximum
    reported. K2 drains the psummed bins once."""
    import torch

    from veneur_tpu_torch.ops import hll
    from veneur_tpu_torch.parallel.global_agg import (GlobalAggregator,
                                                      make_host_batch)

    mesh = _shard_mesh(dev)
    agg = GlobalAggregator(mesh, series)
    t0 = time.perf_counter()
    batch = make_host_batch(mesh.hosts, series, n=samples, m=sets,
                            c=counters, seed=SEED + 31)
    rec = {"series": series, "mesh": mesh.shape, "samples": batch.h_rows.size,
           "set_members": batch.s_rows.size,
           "counter_incs": batch.c_rows.size,
           "batch_build_s": time.perf_counter() - t0}
    state = agg.init_state()
    dbatch = agg.shard_batch(batch)
    _sync(dev)
    t0 = time.perf_counter()
    state, pcts, est, counters = agg.step(state, dbatch, MESH_QS)
    _sync(dev)
    rec["step_s"] = time.perf_counter() - t0
    want = np.zeros(series, np.int64)
    np.add.at(want, batch.c_rows.reshape(-1), batch.c_incs.reshape(-1))
    if not np.array_equal(counters.cpu().numpy(), want):
        raise AssertionError("aggregator counters differ from np.add.at")
    oracle = torch.zeros_like(state.registers)
    hll.insert(oracle, dbatch.s_rows.reshape(-1), dbatch.s_hi.reshape(-1),
               dbatch.s_lo.reshape(-1), precision=agg.precision)
    if not torch.equal(oracle, state.registers):
        raise AssertionError("aggregator registers differ from one "
                             "device's scatter-max")
    part = slice(0, 1 << 14)
    if not torch.equal(hll.estimate(oracle[part], agg.precision),
                       est[part]):
        raise AssertionError("aggregator estimates differ")
    del oracle
    rows = batch.h_rows.reshape(-1).astype(np.int64)
    keep = np.arange(series) % 5 == 0
    rr, exact, span = _grouped_quantiles(rows, batch.h_vals.reshape(-1),
                                         MESH_QS, keep)
    got = pcts[torch.from_numpy(rr).to(dev)].cpu().numpy()
    err = (np.abs(got - exact) / np.maximum(span, 1e-6)[:, None]).max(1)
    p99 = float(np.percentile(err, 99))
    rec.update(checked_rows=len(rr), pct_err_of_span_max=float(err.max()),
               pct_err_of_span_p99=p99,
               rows_past_015=int((err >= 0.15).sum()))
    if p99 >= 0.15 or len(rr) < series // 6:
        raise AssertionError(f"aggregator percentiles off np.quantile: "
                             f"p99 {p99:.3g} of the span over {len(rr)} "
                             "rows")
    mass = state.digest.weight.double().sum(1).cpu().numpy()
    if not np.array_equal(mass, np.bincount(rows, minlength=series)):
        raise AssertionError("aggregator digest mass differs from the "
                             "samples'")
    return rec


def run_mesh_butterfly(dev, series: int = MESH_SERIES) -> tuple:
    """merge_forwarded_digests at ``series`` rows and hosts 2: one
    butterfly round, K2 over both hosts' rows with two ascending K-wide
    halves. Its K2 is held to compress_presorted_plain on the same inputs
    (host 0's pair, where the plain version fits beside the state), the
    total mass must be exact, and the K2 call on one pair is timed
    (median of 20) beside its byte bound and its plain version. Returns
    (record, the main-path launch counts, the kernels-line row)."""
    import torch

    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.parallel.global_agg import GlobalAggregator

    agg = GlobalAggregator(_shard_mesh(dev), series)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 33)
    ma, wa, mb, wb, mn, mx = _random_halves(series, agg.k, dev, gen)
    mean, weight = torch.stack([ma, mb]), torch.stack([wa, wb])
    mins = torch.stack([mn, mn])
    maxs = torch.stack([mx, mx])
    _sync(dev)
    _reset_counts(tc)
    with _capture_launches(tc, "launch_compress_presorted") as calls:
        t0 = time.perf_counter()
        merged = agg.merge_forwarded_digests(mean, weight, mins, maxs)
        _sync(dev)
        rec = {"series": series, "hosts": MESH_HOSTS,
               "first_call_s": time.perf_counter() - t0}
    counts = _counts(tc)
    if counts["compress_presorted.launches"] != 1 or len(calls) != 1 \
            or counts["compress_presorted.sort_b_launches"]:
        raise AssertionError(f"the butterfly launched {counts}")
    (args, out), = calls
    if args[-1] is not False or args[0].shape[0] != 2 * series:
        raise AssertionError("the butterfly's K2 took sort_b or another "
                             "shape")
    mass = (wa.double().sum(1) + wb.double().sum(1))
    if not torch.equal(merged.weight.double().sum(1), mass):
        raise AssertionError("the butterfly lost mass")
    del calls, args, out
    got = (merged.mean, merged.weight)
    want = tc.compress_presorted_plain(ma, wa, mb, wb, COMPRESSION, agg.k)
    _sync(dev)
    err = _compare("butterfly K2", got, want, wa, wb)
    del want, got
    rec["max_abs_err"] = err
    rec["butterfly_ms"] = _median_ms(
        lambda: agg.merge_forwarded_digests(mean, weight, mins, maxs),
        TIMED_LAUNCHES)
    k2_ms = _median_ms(lambda: tc.compress_presorted(
        ma, wa, mb, wb, COMPRESSION, agg.k), TIMED_LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(PLAIN_RUNS):
        tc.compress_presorted_plain(ma, wa, mb, wb, COMPRESSION, agg.k)
        _sync(dev)
    plain_ms = (time.perf_counter() - t0) / PLAIN_RUNS * 1e3
    nbytes, ops = _work(series, agg.k, agg.k, agg.k, 0, False, False)
    bound_ms, bound_by = _bound(nbytes, ops)
    rec.update(k2_pair_ms=k2_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes)
    row = {"max_abs_err": err, "ms": k2_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    return rec, counts, row


def run_mesh_server(dev) -> tuple:
    """A mesh global Server (mesh_enabled, mesh_hosts 2, 4 x 2 on the
    card) fed over native:// with the two states native_merge's locals
    forwarded into the dense global; its columnar flush is held to that
    dense global's: every percentile within rtol 1e-5, counts, extrema,
    counters and set estimates equal. Returns (record, launch counts)."""
    from veneur_tpu_torch import flusher
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.fleet import balance_ratio, fleet_snapshot
    from veneur_tpu_torch.forward.native_transport import NativeForwarder
    from veneur_tpu_torch.native import egress
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server

    states, dense, rows, set_series, gcounters = _RECORDS.pop(
        "native_merge_states")
    sink = _ColumnarRecorder()
    server = Server(Config(
        native_import_address="127.0.0.1:0", interval="86400s",
        percentiles=list(PERCENTILES), aggregates=["min", "max", "count"],
        hostname="mesh", store_initial_capacity=1024, store_chunk=1 << 14,
        max_series=INGEST_MAX_SERIES, mesh_enabled=True,
        mesh_hosts=MESH_HOSTS), metric_sinks=[sink], device=dev,
        mesh=_shard_mesh(dev))
    store, srv = server.store, None
    split = {"decode_s": 0.0, "miss_loop_s": 0.0, "import_columnar_s": 0.0,
             "merge_s": 0.0}
    real_decode = egress.decode_metric_list

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[key] += time.perf_counter() - t0
        return run

    _reset_counts(tc)
    server.start()
    try:
        srv = server.native_import_server
        egress.decode_metric_list = timed("decode_s", real_decode)
        store._intern_mlist = timed("miss_loop_s", store._intern_mlist)
        store.import_columnar = timed("import_columnar_s",
                                      store.import_columnar)
        srv._merge = timed("merge_s", srv._merge)
        for state in states:
            fwd = NativeForwarder(f"native://127.0.0.1:{srv.port}",
                                  timeout=600.0)
            try:
                if fwd.forward(state) is not True:
                    raise AssertionError(f"native forward into the mesh "
                                         f"global failed ({fwd.errors})")
            finally:
                fwd.close()
        egress.decode_metric_list = real_decode
        t0 = time.perf_counter()
        with store._lock:
            store.histograms._drain_staging()
            store.sets._drain_staging()
        _sync(dev)
        split["final_drain_s"] = time.perf_counter() - t0
        split["staging_and_drains_s"] = (split["import_columnar_s"]
                                         - split["miss_loop_s"])
        snap = fleet_snapshot(store)
        t0 = time.perf_counter()
        flusher.flush_once(server)
        rec = {"flush_s": time.perf_counter() - t0,
               "last_fleet_occupancy": store.last_fleet_occupancy}
    finally:
        egress.decode_metric_list = real_decode
        server.shutdown()
    if srv.import_errors or srv.received != 2 * (rows + set_series
                                                 + gcounters):
        raise AssertionError(f"mesh import: {srv.received} merged, "
                             f"{srv.import_errors} errors")
    rec.update(import_s=split["merge_s"] + split["final_drain_s"],
               import_split=split, shard_occupancy=snap["shard_occupancy"],
               balance_ratio=snap["balance_ratio"],
               histogram_occupancy=snap["groups"]["histograms"])
    if rec["last_fleet_occupancy"] != snap["shard_occupancy"]:
        raise AssertionError("the swap stamped another occupancy")
    if snap["balance_ratio"] != balance_ratio(snap["shard_occupancy"]):
        raise AssertionError("balance ratio")
    col = sink.flushes.get(timeout=60)
    got, want = _blocks_by_prefix(col, 0), _blocks_by_prefix(dense, 0)
    if set(got) != {"h", "s"} or set(want) != set(got):
        raise AssertionError(f"mesh blocks {sorted(got)} vs dense "
                             f"{sorted(want)}")
    for key, (blk, names) in got.items():
        wblk, wnames = want[key]
        if sorted(names) != sorted(wnames) or blk.suffixes != wblk.suffixes:
            raise AssertionError(f"mesh group {key}: names or suffixes "
                                 "differ from the dense global's")
        g, w = _block_matrix(blk), _block_matrix(wblk)
        g = g[np.argsort(names)]
        w = w[np.argsort(wnames)]
        sfx = [x.decode() for x in blk.suffixes]
        pc = [i for i, x in enumerate(sfx) if x.endswith("percentile")]
        other = [i for i in range(len(sfx)) if i not in pc]
        if not np.array_equal(g[:, other], w[:, other]):
            raise AssertionError(f"mesh group {key}: counts, extrema or "
                                 "estimates differ from the dense global's")
        if pc:
            rel = np.abs(g[:, pc] - w[:, pc]) / np.maximum(np.abs(w[:, pc]),
                                                           1e-30)
            rec["pct_rel_err_vs_dense"] = float(rel.max())
            if rel.max() > 1e-5:
                raise AssertionError(f"mesh percentiles off the dense "
                                     f"global's by rel {rel.max():.3g}")
    gx = sorted((m.name, tuple(m.tags), m.value) for m in col.extras)
    wx = sorted((m.name, tuple(m.tags), m.value) for m in dense.extras)
    if gx != wx or len(gx) != gcounters:
        raise AssertionError("mesh counters differ from the dense global's")
    rec["histogram_series"], rec["set_series"] = rows, set_series
    rec["global_counters"] = gcounters
    return rec, _counts(tc)


def run_mesh_checkpoint(dev, aggs, series: int = MESH_CKPT_ROWS) -> tuple:
    """A mesh store's checkpoint at ``series`` histogram series: written
    to local disk, read back, restored into a fresh mesh store and into
    a dense store, whose flushes are the same rows (percentiles within
    1e-5 of the span, count/min/max exact, sums rel 1e-6) and hold the
    source's own flush within 0.02 of the span."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.persist import (deserialize, read_file,
                                          serialize, write_atomic)

    _, samples = _cap_lines(series, CAP_HOT, SEED + 35)
    src = _fed_store(dev, "dense", samples, mesh=_shard_mesh(dev))
    _reset_counts(tc)
    t0 = time.perf_counter()
    groups, _ = src.snapshot_state()
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(CKPT_DIR / "mesh.ckpt")
    write_atomic(path, serialize(groups, created_at=time.time(),
                                 interval=10.0))
    rec = {"series": series, "write_s": time.perf_counter() - t0,
           "bytes": os.path.getsize(path)}
    blob = deserialize(read_file(path))[0]
    os.remove(path)
    out = {}
    for label, kw in (("mesh", {"mesh": _shard_mesh(dev)}), ("dense", {})):
        dst = _fed_store(dev, "dense", {}, **kw)
        t0 = time.perf_counter()
        n = dst.restore_state(blob)
        rec[f"{label}_restore_s"] = time.perf_counter() - t0
        if n != series:
            raise AssertionError(f"{label} restored {n} of {series} series")
        rows = _store_rows(dst, aggs)
        out[label] = {k: v for k, v in rows.items()
                      if k[0].startswith("cap.h.")}
    counts = _counts(tc)
    want = {k: v for k, v in _store_rows(src, aggs).items()
            if k[0].startswith("cap.h.")}
    rec["mesh_vs_dense"] = _hold_rows("mesh restore vs dense restore",
                                      out["mesh"], out["dense"], samples,
                                      1e-5)
    rec["mesh_vs_source"] = _hold_rows("mesh restore vs source",
                                       out["mesh"], want, samples, 0.02)
    rec["launches"] = counts
    return rec, counts


def run_mesh_ladder(dev, aggs, series: int = MESH_LADDER_ROWS) -> tuple:
    """Rung 3 on a mesh group: a FaultInjector fails the flush kernel at
    preflight, the retired mesh group re-merges into the live one
    (through its placement) and emits at the next flush, held to a mesh
    twin that never failed. The phase's only store allowed to requeue."""
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.resilience.faults import FaultInjector

    _, samples = _cap_lines(series, CAP_HOT, SEED + 37)
    store = _fed_store(dev, "dense", samples, mesh=_shard_mesh(dev))
    twin = _fed_store(dev, "dense", samples, mesh=_shard_mesh(dev))
    if store.compute in _BREAKERS:
        _BREAKERS.remove(store.compute)
    store.compute.injector = FaultInjector(
        rate=1.0, seed=SEED, kinds=("connect",),
        scope="compute.tdigest_merge")
    _reset_counts(tc)
    t0 = time.perf_counter()
    faulted = _store_rows(store, aggs)
    rec = {"series": series, "faulted_flush_s": time.perf_counter() - t0}
    store.compute.injector = None
    t0 = time.perf_counter()
    late = _store_rows(store, aggs)
    rec["late_flush_s"] = time.perf_counter() - t0
    counts = _counts(tc)
    want = _store_rows(twin, aggs)
    c = store.compute
    rec.update(requeued_total=c.requeued_total, lost_total=c.lost_total)
    if any(k[0].startswith("cap.h.") for k in faulted) or \
            (c.requeued_total, c.lost_total) != (1, 0):
        raise AssertionError(f"mesh rung 3: {rec}")
    late = {k: v for k, v in late.items() if k[0].startswith("cap.h.")}
    want = {k: v for k, v in want.items() if k[0].startswith("cap.h.")}
    rec.update(_hold_rows("mesh rung 3", late, want, samples, 0.02))
    rec["launches"] = counts
    return rec, counts


def phase_mesh(dev, card: str) -> dict:
    """The mesh-sharded global tier on a 4 x 2 shard mesh on the card:
    the standalone interval step and the butterfly at 1,048,576 series,
    a mesh global Server fed native_merge's two 1M-series states over
    native://, a mesh checkpoint restored into a mesh and a dense store,
    and rung 3 on a mesh group; one line a subphase, each subphase's
    state freed before the next. Returns the main-path launch counts
    (the plain-version holds and the timing runs excepted)."""
    import torch

    from veneur_tpu_torch.samplers.intermetric import HistogramAggregates

    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    counts = {}
    t_phase = time.perf_counter()

    def aggregator():
        from veneur_tpu_torch.ops import tdigest_cuda as tc

        _reset_counts(tc)
        rec = run_mesh_aggregator(dev)
        c = _counts(tc)
        if c["compress_presorted.launches"] != 1:
            raise AssertionError(f"the aggregator step launched {c}")
        rec["launches"] = c
        return rec, c

    def butterfly():
        rec, c, row = run_mesh_butterfly(dev)
        _RECORDS["mesh_butterfly"] = dict(row, launches=c[
            "compress_presorted.launches"])
        rec["launches"] = c
        return rec, c

    def server():
        rec, c = run_mesh_server(dev)
        if c["drain_quantile.launches"] < 1 or \
                c["compress_presorted.launches"] < 1:
            raise AssertionError(f"the mesh Server launched {c}")
        rec["launches"] = c
        return rec, c

    for name, run in (("aggregator", aggregator), ("butterfly", butterfly),
                      ("server", server),
                      ("checkpoint", lambda: run_mesh_checkpoint(dev, aggs)),
                      ("ladder", lambda: run_mesh_ladder(dev, aggs))):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rec, c = run()
        _add_counts(counts, c)
        rec["max_memory_allocated"] = int(torch.cuda.max_memory_allocated(
            dev))
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "mesh", "subphase": name, "card": card, **rec,
              "subphase_s": time.perf_counter() - t0})
    emit({"phase": "mesh", "card": card, "launches": counts,
          "phase_s": time.perf_counter() - t_phase})
    return counts


FHA_GAUGES = 4096                # leg (a): global-only gauges on A
FHA_TOPK = 4096                  # leg (a): veneurtopk series on A
FHA_TOPK_SAMPLES = 8             # their members a series, Zipf(1.1)
FHA_EVERY = 64                   # a series in 64 takes new-ring samples
FHA_SHIFT = 5000.0               # the new samples' offset (disjoint)
FHA_STORE_CHUNK = 1 << 14        # leg (a)'s stores' staging chunk
FHA_SBY_SERIES = 1 << 16         # leg (b): histogram series
FHA_SBY_SETS = 4096              # leg (b): sets, counters and gauges
FHA_SBY_EVERY = 16               # leg (b): a series in 16 re-routed
FHA_LEASE_TTL = "1s"
FHA_LEASE_RENEW = "250ms"
FHA_MESH_SERIES = 1 << 19        # leg (c): histogram series
FHA_MESH_CHUNK = 1 << 16         # leg (c): the stores' staging chunk
FHA_MESH_FEED = 1 << 14          # leg (c): rows a sample_many call
FHA_MESH_HOT_EVERY = 64          # leg (c): 1/64 of the series hot ...
FHA_MESH_HOT_SAMPLES = 128       # ... with 128 samples an interval
FHA_MESH_SERVER_SERIES = 1 << 16  # leg (c): the UDP Server's series


def _fha_server(dev, tag: str, peers=None, mesh=None, **extra):
    """A port global Server for fleet_ha: HTTP (the fleet routes), gRPC
    and native:// imports, a UDP listener, a columnar recorder; with
    ``peers`` (a file) elastic resharding on over it, refreshed only by
    the caller. Returns (server, sink, http address)."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.server import Server

    kw = dict(http_address="127.0.0.1:0", grpc_address="127.0.0.1:0",
              native_import_address="127.0.0.1:0",
              statsd_listen_addresses=["udp://127.0.0.1:0"],
              interval="86400s", percentiles=list(PERCENTILES),
              aggregates=["min", "max", "count"], hostname=tag,
              max_series=INGEST_MAX_SERIES, forward_timeout="600s",
              store_chunk=FHA_STORE_CHUNK)
    if peers is not None:
        kw.update(handoff_enabled=True, handoff_self=tag,
                  handoff_peers=f"file://{peers}",
                  handoff_refresh_interval="86400s",
                  handoff_timeout="600s")
    kw.update(extra)
    sink = _ColumnarRecorder()
    server = Server(Config(**kw), metric_sinks=[sink], device=dev,
                    mesh=mesh)
    server.start()
    addr = f"127.0.0.1:{server.ops_server.port}"
    if server.handoff_manager is not None:
        server.handoff_manager.self_addr = addr
    return server, sink, addr


def _fha_rows(server, sink, part: int = 0, own=None) -> tuple:
    """One flush of a global Server: ({block prefix (the dotted ``part``
    of its names): (names, matrix, suffixes)}, {(name, tags): value} of
    the extras); ``own`` (a dict) takes the server's own rows
    (``_own_values``)."""
    from veneur_tpu_torch import flusher

    flusher.flush_once(server)
    col = sink.flushes.get(timeout=600)
    if own is not None:
        own.update(_own_values(col))
    blocks = {k: (names, _fha_matrix(blk),
                  [s.decode() for s in blk.suffixes])
              for k, (blk, names) in _blocks_by_prefix(col, part).items()}
    extras = {(m.name, tuple(m.tags)): m.value for m in col.extras
              if not m.name.startswith("veneur.")}
    return blocks, extras


def _fha_matrix(blk):
    """A block's emissions as an [S, suffixes] matrix, NaN where a row
    emits no such suffix (a global's row of imported digests alone has
    no local count, min or max); each cell at most once."""
    nsfx, n = len(blk.suffixes), len(blk.names[1])
    cell = blk.rows.astype(np.int64) * nsfx + blk.suffix_idx
    if np.bincount(cell, minlength=n * nsfx).max(initial=0) > 1:
        raise AssertionError("a block emits a (series, suffix) twice")
    out = np.full(n * nsfx, np.nan)
    out[cell] = blk.values
    return out.reshape(n, nsfx)


def _fha_span(m, col) -> np.ndarray:
    """Each digest row's value span: max - min where the row has them,
    and at least its 1st-to-99th percentile range."""
    rng = m[:, col[".99percentile"]] - m[:, col[".1percentile"]]
    if ".max" not in col:
        return rng
    return np.fmax(rng, m[:, col[".max"]] - m[:, col[".min"]])


def _fha_spilled(server) -> dict:
    """Each store group's first-sight series spilled to its overflow row
    (past ``max_series`` or under the overload freeze), where nonzero."""
    st = server.store
    return {n: getattr(st, n).spilled for n in st._GEN_GROUPS
            if getattr(st, n).spilled}


def _fha_udp(server, lines) -> int:
    """``lines`` into ``server``'s UDP lanes in paced bursts; waits until
    the fleet merged every record, with no kernel drop. A lane seals a
    chunk at each short recv batch and at each full chunk, so a burst of
    n datagrams, each smaller than a chunk, adds at most n + 1 sealed
    chunks: a burst holds one less than half the low watermark's share
    of a lane's backlog, and before each one the sender waits until the
    burst before it is parsed and every lane's backlog is under that
    half. So the backlog stays under the low watermark and the overload
    ladder at level 0: at level 1 a first-sight series spills to the
    overflow row (merged, but under another name), at level 3 the lanes
    shed datagrams. Either fails here, by name. Returns the records
    sent."""
    t = _pack_lines(lines)
    blob, off, ln = t["blob"], t["d_off"].tolist(), t["d_len"].tolist()
    dgrams = [blob[o:o + n] for o, n in zip(off, ln)]
    ends = np.cumsum(t["d_lines"])
    fleet = server.ingest_fleets[0]
    port = server.statsd_addrs[0][1]
    base = fleet.totals()["merged"]
    shed0 = sum(server.overload.shed.values())
    spilled0 = _fha_spilled(server)
    calm = server.overload.low / 2.0
    per = max(1, int(calm * min(lane._max_backlog for lane in fleet.lanes))
              - 1)

    def lost() -> None:
        if sum(server.overload.shed.values()) != shed0:
            raise AssertionError(f"the server shed datagrams: "
                                 f"{server.overload.shed}")
        if _fha_spilled(server) != spilled0:
            raise AssertionError(
                f"first-sight series spilled to the overflow row: "
                f"{_fha_spilled(server)} (before {spilled0}; overload "
                f"{server.overload.snapshot()})")

    def taken(n: int) -> bool:
        lost()
        return (fleet.totals()["parsed"] >= base + int(ends[n - 1])
                and fleet.pressure() < calm)

    _udp_send(port, dgrams, taken, per=per, timeout=600)
    _wait_for(lambda: fleet.totals()["merged"] >= base + len(lines), 600,
              "the lanes to merge the UDP lines")
    lost()
    if _udp_drops(port):
        raise AssertionError(f"the kernel dropped {_udp_drops(port)} "
                             "datagrams")
    return len(lines)


def _fha_feed(dev, server, frames, gauges, topk_lines) -> None:
    """native_merge's local A frames over gRPC into ``server`` (1,048,576
    packed digests, 32,768 sets, 4,096 counters), then the global-only
    gauges and the veneurtopk lines through its store."""
    from veneur_tpu_torch.forward.grpc_forward import GRPCForwarder
    from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric

    fwd = GRPCForwarder(f"127.0.0.1:{server.import_server.port}",
                        timeout=600.0)
    try:
        if fwd.send_frames(frames) is not True:
            raise AssertionError(f"gRPC feed failed ({fwd.errors} errors)")
    finally:
        fwd.close()
    store = server.store
    for i, v in enumerate(gauges.tolist()):
        store.import_gauge(MetricKey(f"gg.{i}", "gauge", ""), [], v)
    for ln in topk_lines:
        store.process_metric(parse_metric(ln))
    _sync(dev)


def _fha_owned(server, tr, me: str) -> int:
    """Every ring-routed series of ``server``'s store on the owner the
    transition names (``me``); returns the series checked."""
    st, n = server.store, 0
    for name in st._HANDOFF_GROUPS:
        it = getattr(st, name).interner
        ix = [i for i, nm in enumerate(it.names)
              if not nm.startswith("veneur.")]
        owners = tr.new_owners([it.names[i] for i in ix],
                               st._GROUP_TYPES[name],
                               [it.joined[i] for i in ix])
        bad = sum(o != me for o in owners)
        if bad:
            raise AssertionError(f"{name}: {bad} series of {me} belong "
                                 "elsewhere")
        n += len(ix)
    return n


def _fha_check_union(a, b, c, rec) -> None:
    """A's and B's flushes against the twin C's: no series on both, the
    union C's rows; counters, gauges, set estimates, digest counts and
    extrema equal C's; percentiles within 0.02 x (max - min) of C's (the
    pack's u16 means); the top-k rows equal C's."""
    (ab, ax), (bb, bx), (cb, cx) = a, b, c
    if set(ab) | set(bb) != set(cb):
        raise AssertionError(f"blocks {sorted(ab)} + {sorted(bb)} vs "
                             f"{sorted(cb)}")
    pct_err, on_b = 0.0, 0
    for key, (cnames, cm, csfx) in cb.items():
        got = {}
        for blocks in (ab, bb):
            if key not in blocks:
                continue
            names, m, sfx = blocks[key]
            if sfx != csfx:
                raise AssertionError(f"{key}: suffixes {sfx} vs {csfx}")
            for nm, row in zip(names, m):
                if nm in got:
                    raise AssertionError(f"{nm} on both A and B")
                got[nm] = row
        if set(got) != set(cnames):
            raise AssertionError(f"{key}: A and B hold {len(got)} rows, "
                                 f"the twin {len(cnames)}")
        if key in bb:
            on_b += len(bb[key][0])
        g = np.stack([got[nm] for nm in cnames])
        if key != "h":
            if not np.array_equal(g, cm, equal_nan=True):
                raise AssertionError(f"{key}: values differ from the twin")
            continue
        col = {s: i for i, s in enumerate(csfx)}
        for s in (".count", ".min", ".max"):
            if not np.array_equal(g[:, col[s]], cm[:, col[s]],
                                  equal_nan=True):
                raise AssertionError(f"digest {s} differs from the twin")
        span = _fha_span(cm, col)
        pc = [i for s, i in col.items() if s.endswith("percentile")]
        err = np.abs(g[:, pc] - cm[:, pc]) / np.maximum(span, 1e-30)[:, None]
        pct_err = max(pct_err, float(err.max()))
    if pct_err > 0.02:
        raise AssertionError(f"percentiles off by {pct_err:.3g} of the span")
    if set(ax) & set(bx) or {**ax, **bx} != cx or not cx:
        raise AssertionError(f"top-k rows: A {len(ax)} + B {len(bx)} vs "
                             f"the twin's {len(cx)}")
    rec.update(rows_on_b=on_b, pct_err_of_span=pct_err,
               topk_rows=[len(ax), len(bx)])


def _fha_topk_bound(extras, exact, depth: int, width: int) -> dict:
    """The top-k rows against the exact counts: never under, and at most
    a share e^-depth past exact + e/w x N, N the table's mass (the
    count-min guarantee: the table went whole with every part, so each
    part's estimates stay one-sided)."""
    n = sum(exact.values())
    slack = math.e / width * n
    over = []
    for (name, tags), v in extras.items():
        if not name.endswith(".topk"):
            continue
        member = [t[4:] for t in tags if t.startswith("key:")][0]
        want = exact.get((name[:-len(".topk")], member))
        if want is None or v < want:
            raise AssertionError(f"top-k {name} {member}: {v} vs exact "
                                 f"{want}")
        over.append(v - want)
    over = np.array(over)
    share = float(np.mean(over > slack)) if len(over) else 1.0
    if not len(over) or share > math.exp(-depth):
        raise AssertionError(f"top-k: {share:.4f} of {len(over)} rows past "
                             f"exact + {slack:.1f}")
    return {"topk_mass": n, "topk_slack": slack,
            "topk_over_bound_share": share,
            "topk_over_max": float(over.max())}


def run_fleet_handoff(dev, workdir) -> tuple:
    """Leg (a): elastic resharding at fleet cardinality (see
    phase_fleet_ha). Returns the record."""
    import urllib.request

    from veneur_tpu_torch.fleet import RingTransition
    from veneur_tpu_torch.fleet import handoff as ho
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    src = _RECORDS.pop("native_merge_frames")
    frames, rows = src["frames"][0], src["rows"]
    rng = np.random.default_rng(SEED + 61)
    gauges = np.round(rng.normal(0, 100, FHA_GAUGES), 3)
    zipf = (rng.zipf(1.1, (FHA_TOPK, FHA_TOPK_SAMPLES)) - 1) % 4096
    topk_lines = [f"k.{i}:m{m}|s|#veneurtopk".encode()
                  for i in range(FHA_TOPK) for m in zipf[i].tolist()]
    exact = {}
    for i in range(FHA_TOPK):
        for m in zipf[i].tolist():
            exact[(f"k.{i}", f"m{m}")] = exact.get((f"k.{i}", f"m{m}"),
                                                    0) + 1
    workdir.mkdir(parents=True, exist_ok=True)
    peers = workdir / "fha.peers"
    rec = {"histogram_series": rows, "set_series": src["set_series"],
           "global_counters": src["gcounters"], "gauges": FHA_GAUGES,
           "topk_series": FHA_TOPK}
    servers = []
    try:
        a, a_sink, addr_a = _fha_server(dev, "a", peers)
        servers.append(a)
        b, b_sink, addr_b = _fha_server(dev, "b", peers)
        servers.append(b)
        c, c_sink, _ = _fha_server(dev, "c")
        servers.append(c)
        peers.write_text(f"{addr_a}\n")
        mgr = a.handoff_manager
        if mgr.refresh() != {"adopted": [addr_a]}:
            raise AssertionError("A did not adopt its membership")
        # the new ring: who owns each ring-routed series after B joins
        tr = RingTransition([addr_a], [addr_a, addr_b])
        hnames = [f"h.{i}" for i in range(rows)]
        cnames = [f"g.c.{i}" for i in range(src["gcounters"])]
        t0 = time.perf_counter()
        h_to_b = np.array(tr.new_owners(hnames, "histogram",
                                        [""] * rows)) == addr_b
        c_to_b = np.array(tr.new_owners(cnames, "counter",
                                        [""] * len(cnames))) == addr_b
        rec["route_s"] = time.perf_counter() - t0
        # the proxy routes NEW samples by the new ring the moment it
        # changes: every 64th series' owner takes 8 samples shifted far
        # from its state (so the import drains that meet them trip the
        # guard: K2 on both sides), the counters one increment each
        every = np.arange(0, rows, FHA_EVERY)
        new_b = every[h_to_b[every]]
        new_a = every[~h_to_b[every]]
        ctr_b = np.arange(len(cnames))[c_to_b][::8]
        ctr_a = np.arange(len(cnames))[~c_to_b][::8]

        def lines(hrows, crows):
            out = [f"h.{i}:{FHA_SHIFT + j + (i % 97):.1f}|h"
                   for i in hrows.tolist() for j in range(8)]
            out += [f"g.c.{i}:1|c|#veneurglobalonly" for i in crows.tolist()]
            return out

        b_lines, a_lines = lines(new_b, ctr_b), lines(new_a, ctr_a)
        # the twin C runs whole before the main path, so its launches
        # stay out of the counts: the same state, every new-ring sample,
        # no resize; flushed and shut down
        with _uncounted(tc):
            _fha_feed(dev, c, frames, gauges, topk_lines)
            _fha_udp(c, b_lines + a_lines)
            fc = _fha_rows(c, c_sink)
            servers.remove(c)
            c.shutdown()
        t0 = time.perf_counter()
        _fha_feed(dev, a, frames, gauges, topk_lines)
        rec["feed_s"] = time.perf_counter() - t0
        _fha_udp(b, b_lines)
        # A's new-ring samples arrive DURING the extraction: after its
        # generation swap, snapshot and split, before its kept half
        # re-merges (the re-merge waits for them), so the kept rows hold
        # newer data
        go, landed = threading.Event(), threading.Event()
        real_swap = a.store._swap_generation
        real_restore = a.store.restore_state
        real_split = ho.split_group_snapshot
        marks = {"split_s": 0.0}

        def swap():
            gen = real_swap()
            marks["swap"] = time.perf_counter()
            return gen

        def split(*args, **kwargs):
            t = time.perf_counter()
            marks.setdefault("split0", t)
            out = real_split(*args, **kwargs)
            marks["split_s"] += time.perf_counter() - t
            return out

        def restore(groups, prefer_live_scalars=False):
            a.store.restore_state = real_restore
            t = time.perf_counter()
            go.set()
            landed.wait(600)
            marks["held_s"] = time.perf_counter() - t
            c0 = _counts(tc)
            t = time.perf_counter()
            n = real_restore(groups, prefer_live_scalars=prefer_live_scalars)
            marks["kept_s"] = time.perf_counter() - t
            marks["kept_counts"] = {k: v - c0[k] for k, v in
                                    _counts(tc).items()}
            return n

        def ingest_during():
            go.wait(600)
            try:
                marks["udp_records"] = _fha_udp(a, a_lines)
            finally:
                landed.set()

        sent = []
        real_send = mgr._send

        def send(dest, blob, handoff_id, **kw):
            sent.append((dest, blob, handoff_id))
            return real_send(dest, blob, handoff_id, **kw)

        recv = b.handoff_manager
        real_handle = recv.handle_handoff
        first_k2 = {}

        def handle(body, headers=None):
            c0 = _counts(tc)
            with _first_launch(tc, "launch_compress_presorted") as k2:
                out = real_handle(body, headers=headers)
            first_k2["call"] = k2.call
            first_k2["counts"] = {k: v - c0[k] for k, v in
                                  _counts(tc).items()}
            return out

        a.store._swap_generation = swap
        a.store.restore_state = restore
        ho.split_group_snapshot = split
        mgr._send = send
        recv.handle_handoff = handle
        udp = threading.Thread(target=ingest_during, daemon=True)
        udp.start()
        peers.write_text(f"{addr_a}\n{addr_b}\n")
        try:
            t0 = time.perf_counter()
            summary = mgr.refresh()
            rec["resize_s"] = time.perf_counter() - t0
        finally:
            a.store._swap_generation = real_swap
            a.store.restore_state = real_restore
            ho.split_group_snapshot = real_split
            mgr._send = real_send
            recv.handle_handoff = real_handle
            udp.join(600)
        st = mgr.last_stages
        if "udp_records" not in marks:
            raise AssertionError("the UDP traffic during the extraction "
                                 "did not land")
        if summary["sent"] != [addr_b] or summary["requeued"] or \
                recv.received_series_total != summary["moved_series"] or \
                len(sent) != 1:
            raise AssertionError(f"the handoff: {summary}")
        blob = sent[0][1]
        # the fleet trace plane: B's /debug/trace (A among its fleet peers
        # through the handoff's peers file) holds A's handoff.send and its
        # own receiving hop under one trace id
        send_entry = a.obs_timeline.entries()[-1]
        if send_entry.get("hop") != "handoff.send":
            raise AssertionError(f"A's last entry: {send_entry.get('hop')}")
        rec["trace"] = _stitched(b.ops_server.port, send_entry["trace_id"],
                                 ("handoff.send", "handoff.receive"))
        if first_k2.get("call") is None or marks["kept_counts"][
                "compress_presorted.launches"] < 1:
            raise AssertionError(f"K2 did not run on both sides: kept "
                                 f"{marks['kept_counts']}, receiver "
                                 f"{first_k2.get('counts')}")
        rec["receiver_k2_max_abs_err"] = _hold_to_plain(
            tc, "the receiver's first K2 import drain", first_k2["call"])
        del first_k2["call"]
        extract_s = st["extract"] - marks["held_s"]
        rec.update(
            moved_series=summary["moved_series"],
            extract_s=extract_s,
            swap_and_snapshot_s=marks["split0"] - marks["swap"],
            split_s=marks["split_s"], kept_remerge_s=marks["kept_s"],
            udp_records_during_extract=marks["udp_records"],
            udp_wait_s=marks["held_s"],
            pack_and_encode_s=st["encode"], wire_bytes=len(blob),
            post_until_ack_s=st["stream"],
            receiver_merge_s=recv.last_merge_s,
            sender_k2=marks["kept_counts"]["compress_presorted.launches"],
            receiver_k2=first_k2["counts"]["compress_presorted.launches"],
            receiver_k1=first_k2["counts"]["drain_quantile.launches"])
        # the same handoff again: acked as a duplicate, nothing merged
        sizes = {g: len(getattr(b.store, g)) for g in
                 b.store._HANDOFF_GROUPS}
        req = urllib.request.Request(f"http://{addr_b}/handoff", data=blob,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            body = json.loads(r.read())
        if not body.get("duplicate") or recv.duplicates_total != 1 or \
                sizes != {g: len(getattr(b.store, g)) for g in sizes}:
            raise AssertionError(f"a duplicate handoff merged: {body}")
        rec["duplicate_acked"] = True
        rec["owned_series"] = [_fha_owned(a, tr, addr_a),
                               _fha_owned(b, tr, addr_b)]
        t0 = time.perf_counter()
        fa = _fha_rows(a, a_sink)
        fb = _fha_rows(b, b_sink)
        rec["flush_a_b_s"] = time.perf_counter() - t0
        _fha_check_union(fa, fb, fc, rec)
        hh = a.store.heavy_hitters
        rec.update(_fha_topk_bound({**fa[1], **fb[1]}, exact, hh.depth,
                                   hh.width))
        return rec
    finally:
        for s in servers:
            s.shutdown()
        peers.unlink(missing_ok=True)


def _fha_local(dev, address: str, hist, sets_n: int, ctrs, gauges):
    """A port local Server forwarding over native:// to ``address``,
    fed through its store: histograms sb.h.<i> (rows of ``hist``, NaN =
    no sample), sets sb.s.<i> (16 members each), global-only counters
    sb.c.<i> and gauges sb.g.<i>. Started; the caller flushes and shuts
    it down."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.samplers.parser import MetricKey, parse_metric
    from veneur_tpu_torch.server import Server

    local = Server(Config(
        interval="86400s", hostname="sb-local",
        percentiles=list(PERCENTILES), aggregates=["min", "max", "count"],
        forward_address=f"native://{address}", forward_timeout="600s"),
        device=dev)
    local.start()
    store = local.store
    live = np.flatnonzero(~np.isnan(hist).all(1))
    with store._lock:
        hg = store.histograms
        for i in live.tolist():
            hg.interner.intern(MetricKey(f"sb.h.{i}", "histogram", ""), [])
        hg.ensure_capacity(len(live) - 1)
        hg.sample_many(
            np.repeat(np.arange(len(live), dtype=np.int32), hist.shape[1]),
            hist[live].reshape(-1), np.ones(live.size * hist.shape[1],
                                            np.float32))
    for i in range(sets_n):
        for m in range(16):
            store.process_metric(parse_metric(
                f"sb.s.{i}:m{(i * 7 + m * 13) % 977}|s".encode()))
    for i, v in enumerate(ctrs.tolist()):
        store.process_metric(parse_metric(
            f"sb.c.{i}:{v}|c|#veneurglobalonly".encode()))
    for i, v in enumerate(gauges.tolist()):
        store.process_metric(parse_metric(
            f"sb.g.{i}:{v}|g|#veneurglobalonly".encode()))
    return local


def _fha_forward(local, glob) -> None:
    """One forwarding flush of ``local``, until ``glob`` imported it."""
    before = glob.store.imported
    local.flush()
    if local.wait_forward(600) is not True:
        raise AssertionError("the local's forward failed")
    _wait_for(lambda: glob.store.imported - before
              >= local.forwarder.forwarded, 600, "the global's import")


def run_standby_failover(dev, workdir) -> dict:
    """Leg (b): warm standby and leased failover (see phase_fleet_ha).
    Returns the record."""
    from veneur_tpu_torch.fleet.handoff import encode_handoff
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    rng = np.random.default_rng(SEED + 67)
    n = FHA_SBY_SERIES
    workdir.mkdir(parents=True, exist_ok=True)
    lease = workdir / "fha.lease"
    lease.unlink(missing_ok=True)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    sby_port = probe.getsockname()[1]
    probe.close()
    ha = dict(lease_path=f"file://{lease}", lease_ttl=FHA_LEASE_TTL,
              lease_renew_interval=FHA_LEASE_RENEW)
    rec = {"histogram_series": n, "sets": FHA_SBY_SETS,
           "counters": FHA_SBY_SETS, "gauges": FHA_SBY_SETS,
           "lease_ttl": FHA_LEASE_TTL}
    servers, epochs, act_own = [], [], {}
    try:
        act, act_sink, _ = _fha_server(
            dev, "active", handoff_self="active",
            standby_peers=f"127.0.0.1:{sby_port}", **ha)
        servers.append(act)
        _wait_for(lambda: act.lease_elector.is_leader, 30,
                  "the active to take the lease")
        sby, sby_sink, _ = _fha_server(
            dev, "standby", handoff_self="standby",
            http_address=f"127.0.0.1:{sby_port}", **ha)
        servers.append(sby)
        mgr = sby.standby_manager
        time.sleep(0.5)
        if sby.lease_elector.is_leader:
            raise AssertionError("the standby took a held lease")
        for interval in range(2):
            hist = rng.gamma(2.0, 10.0 + interval, (n, 8)).astype(
                np.float32)
            ctrs = rng.integers(1, 1000, FHA_SBY_SETS)
            gauges = np.round(rng.normal(0, 50, FHA_SBY_SETS), 3)
            local = _fha_local(dev, f"127.0.0.1:"
                               f"{act.native_import_server.port}", hist,
                               FHA_SBY_SETS, ctrs, gauges)
            servers.append(local)
            _fha_forward(local, act)
            if interval:
                # the first flush's span (veneur.ha.* among its samples)
                # re-entered the active
                _wait_for(lambda: "veneur.ha.is_leader" in
                          act.store.gauges.interner.names, 60,
                          "the active's veneur.ha.* rows")
            t0 = time.perf_counter()
            epochs.append(_fha_rows(act, act_sink, 1, own=act_own))
            _wait_for(lambda: mgr.receives_total == interval + 1, 600,
                      "the replicated epoch")
            rec[f"replicate_{interval}_s"] = time.perf_counter() - t0
            rec[f"replicate_{interval}_bytes"] = \
                act.standby_manager.last_replicate_bytes
            rec[f"replicate_{interval}_dispatch_s"] = \
                act.standby_manager.last_replicate_ns / 1e9
            held = {g: len(getattr(sby.store, g)) for g in
                    ("histograms", "sets", "global_gauges",
                     "global_counters")}
            if any(held.values()) or mgr.shadow.series_held() == 0:
                raise AssertionError(f"the shadow reached the live store: "
                                     f"{held}")
            local.shutdown()
            servers.remove(local)
        rec["shadow_series_held"] = mgr.shadow.series_held()
        # the takeover: the active dies holding the lease; a local
        # re-routes to the standby and forwards every 16th series' next
        # samples there, shifted; the promotion waits until they landed,
        # so it merges into rows that hold newer data (K2 on its import
        # drains)
        rerouted = threading.Event()
        real_promote = sby.lease_elector.on_promote
        marks, first = {}, {}

        def promote(epoch):
            marks["leader"] = time.perf_counter()
            rerouted.wait(600)
            c0 = _counts(tc)
            with _first_launch(tc, "launch_compress_presorted") as k2:
                real_promote(epoch)
            first["call"] = k2.call
            first["counts"] = {k: v - c0[k] for k, v in _counts(tc).items()}
            marks["promoted"] = time.perf_counter()

        sby.lease_elector.on_promote = promote
        hot = np.arange(0, n, FHA_SBY_EVERY)
        hist3 = np.full((n, 8), np.nan, np.float32)
        hist3[hot] = (FHA_SHIFT + rng.gamma(2.0, 10.0, (len(hot), 8))
                      ).astype(np.float32)
        t_kill = time.perf_counter()
        act.crash_stop()
        servers.remove(act)
        local = _fha_local(dev, f"127.0.0.1:{sby.native_import_server.port}",
                           hist3, 0, np.empty(0, np.int64), np.empty(0))
        servers.append(local)
        _fha_forward(local, sby)
        rec["reroute_forward_s"] = time.perf_counter() - t_kill
        shadow = mgr.shadow.latest()["active"][1]["histograms"]
        rerouted.set()
        _wait_for(lambda: "promoted" in marks, 600, "the promotion")
        rec["promoted_mass_max_rel_err"] = _fha_mass_check(
            sby.store.snapshot_state()[0]["histograms"], shadow, hot)
        promoted = _fha_rows(sby, sby_sink, 1)
        t_flush = time.perf_counter()
        if first.get("call") is None or \
                first["counts"]["compress_presorted.launches"] < 1:
            raise AssertionError(f"the promotion launched {first}")
        rec.update(
            kill_to_leader_s=marks["leader"] - t_kill,
            promote_merge_s=mgr.last_promote_s,
            kill_to_promoted_flush_s=t_flush - t_kill,
            promoted_series=mgr.promoted_series_total,
            promotion_k2=first["counts"]["compress_presorted.launches"],
            promotion_k2_max_abs_err=_hold_to_plain(
                tc, "the promotion's first K2 import drain", first["call"]),
            lease_epoch=sby.lease_elector.lease_epoch)
        del first["call"]
        rec.update(_fha_check_promoted(promoted, epochs[-1], hot))
        # the fleet's self-metrics: the active's flushes emitted
        # veneur.ha.*; the standby recorded a traced replicate hop an
        # epoch, which its promoted flush counted in
        # veneur.trace.hops_total (a row of its next flush)
        ha = {n: v for (n, _), v in act_own.items()
              if n.startswith("veneur.ha.")}
        if ha.get("veneur.ha.is_leader") != 1.0 or \
                "veneur.ha.replicated_total" not in ha:
            raise AssertionError(f"the active's veneur.ha.* rows: {ha}")
        rec["active_ha_rows"] = len(ha)
        _wait_for(lambda: "veneur.trace.hops_total" in
                  sby.store.counters.interner.names, 60,
                  "the standby's veneur.trace.hops_total")
        own = {}
        _fha_rows(sby, sby_sink, 1, own=own)
        hops = own.get(("veneur.trace.hops_total", "hop:ha.replicate"))
        if hops != 2.0:
            raise AssertionError(f"the standby counted {hops} replicate "
                                 "hops, want 2")
        rec["standby_replicate_hops"] = hops
        # the deposed active's late replicate: fenced, nothing merges
        sizes = {g: len(getattr(sby.store, g)) for g in
                 ("histograms", "sets", "global_gauges")}
        blob = encode_handoff(
            {"global_gauges": {"kind": "scalar", "names": ["late.g"],
                               "joined": [""],
                               "values": np.array([1.0])}},
            {"kind": "replicate", "id": "late-1", "sender": "active",
             "epoch": 99, "lease_epoch": 1, "incarnation": "x",
             "series": 1}, time.time())
        status, _, _ = mgr.handle_replicate(blob)
        if status != 409 or mgr.fenced_total != 1 or sizes != {
                g: len(getattr(sby.store, g)) for g in sizes}:
            raise AssertionError(f"a deposed active's replicate: {status}")
        rec["fenced_status"] = status
        return rec
    finally:
        for s in servers:
            s.shutdown()
        lease.unlink(missing_ok=True)
        for p in workdir.glob("fha.lease*"):
            p.unlink()


def _fha_mass_check(snap, shadow, hot) -> float:
    """Digest mass per series of the promoted standby's store against the
    shadow epoch it merged, plus the 8 re-routed samples on the
    re-routed rows: within rtol 1e-6. Returns the largest relative
    error."""
    def mass(s):
        w = np.bincount(np.asarray(s["rows"], np.int64),
                        np.asarray(s["weights"], np.float64),
                        len(s["names"]))
        return dict(zip(s["names"], w.tolist()))

    got, want = mass(snap), mass(shadow)
    if set(got) != set(want):
        raise AssertionError("the promoted store holds other series")
    rerouted = {f"sb.h.{i}" for i in hot.tolist()}
    err = max(abs(got[k] - want[k] - (8.0 if k in rerouted else 0.0))
              / want[k] for k in want)
    if err > 1e-6:
        raise AssertionError(f"promoted digest mass off by {err:.3g}")
    return err


def _fha_check_promoted(promoted, last, hot) -> dict:
    """The promoted standby's flush against the active's last replicated
    epoch: no counter row (every replicated counter was emitted by the
    active; the takeover forwarded none), gauges and set estimates
    equal, the percentiles of the rows the takeover did not touch within
    rtol 1e-5 of the active's, the re-routed rows' 99th percentile among
    their new samples."""
    (got, gx), (want, wx) = promoted, last
    # the global-only counters and gauges are per-row extras
    if any(name.startswith("sb.c.") for name, _ in gx):
        raise AssertionError("a replicated counter was emitted twice")
    gauges = {k: v for k, v in wx.items() if k[0].startswith("sb.g.")}
    if gx != gauges or not gauges or not any(
            k[0].startswith("sb.c.") for k in wx):
        raise AssertionError(f"promoted extras: {len(gx)} vs the active's "
                             f"{len(gauges)} gauges")
    if set(got) != {"h", "s"} or set(want) != {"h", "s"}:
        raise AssertionError(f"promoted groups {sorted(got)}")
    if got["s"][0] != want["s"][0] or not np.array_equal(
            got["s"][1], want["s"][1], equal_nan=True):
        raise AssertionError("promoted set estimates differ")
    gn, gm, sfx = got["h"]
    wn, wm, wsfx = want["h"]
    if sfx != wsfx or sorted(gn) != sorted(wn):
        raise AssertionError("promoted histogram rows differ")
    order = {nm: i for i, nm in enumerate(gn)}
    gm = gm[[order[nm] for nm in wn]]
    col = {s: i for i, s in enumerate(sfx)}
    idx = np.array([int(nm.rsplit(".", 1)[1]) for nm in wn])
    keep = ~np.isin(idx, hot)
    span = _fha_span(wm[keep], col)
    pc = [i for s, i in col.items() if s.endswith("percentile")]
    err = np.abs(gm[keep][:, pc] - wm[keep][:, pc]) / np.maximum(
        span, 1e-30)[:, None]
    rel = np.abs(gm[keep][:, pc] - wm[keep][:, pc]) / np.maximum(
        np.abs(wm[keep][:, pc]), 1e-30)
    if float(rel.max()) > 1e-5:
        raise AssertionError(f"promoted percentiles off by "
                             f"{float(rel.max()):.3g} rel")
    if not np.all(gm[~keep][:, col[".99percentile"]] >= FHA_SHIFT):
        raise AssertionError("a re-routed row lost its new samples")
    return {"promoted_pct_err_of_span": float(err.max()),
            "promoted_pct_max_rel_err": float(rel.max()),
            "promoted_pct_share_within_rtol_1e_5": float(
                (rel <= 1e-5).mean()),
            "rerouted_rows": int((~keep).sum())}


def _mt_feed(g, keys, vals, hot, hot_vals, imp, rec, tag: str) -> np.ndarray:
    """One interval into a tiered group (under its store's lock): every
    series interned through ``g._row`` (the placement assigns there),
    the 8 sample rounds (FHA_MESH_FEED rows a call), the hot series'
    samples, then one sorted 8-centroid import run a series with its
    extrema. Returns each series' row."""
    t0 = time.perf_counter()
    rows = np.fromiter((g._row(k, []) for k in keys), np.int64, len(keys))
    rec[f"{tag}_intern_s"] = time.perf_counter() - t0
    n = len(keys)
    ones = np.ones(FHA_MESH_FEED, np.float32)
    t0 = time.perf_counter()
    for r in range(vals.shape[1]):
        for s in range(0, n, FHA_MESH_FEED):
            e = min(n, s + FHA_MESH_FEED)
            g.sample_many(rows[s:e], vals[s:e, r], ones[:e - s])
    hrows = rows[hot]
    for r in range(hot_vals.shape[1]):
        g.sample_many(hrows, hot_vals[:, r], np.ones(len(hot), np.float32))
    means = np.sort(imp, axis=1)
    g.import_centroids_bulk(np.repeat(rows, imp.shape[1]),
                            means.reshape(-1),
                            np.ones(imp.size, np.float32), rows,
                            means[:, 0].copy(), means[:, -1].copy())
    g._drain_staging()
    rec[f"{tag}_staging_s"] = time.perf_counter() - t0
    return rows


def _fha_rank_err(pcts, exact, qs, block: int = 1 << 15) -> np.ndarray:
    """Each percentile's rank error against its row's exact samples
    (``exact`` sorted, one row a series): how far outside [rank of the
    values below, rank of the values at or below] its quantile lies."""
    n = exact.shape[1]
    q = np.asarray(qs)[None, :]
    out = np.empty(pcts.shape)
    for s in range(0, len(exact), block):
        t = exact[s:s + block, None, :]
        v = pcts[s:s + block, :, None]
        lo = (t < v).sum(2) / n
        hi = (t <= v).sum(2) / n
        out[s:s + block] = np.maximum(0.0, np.maximum(lo - q, q - hi))
    return out


class _PoolDrainLog:
    """A tiered group's pool guard drains against its staging drains,
    for one interval: each staging drain (samples or imports) in order,
    with the rows it bins, and the pool slabs the guard drained within
    it (before binning). Installed on the group's drains and on
    ``_pool_guard_apply`` in both tiered modules; taken off on exit."""

    def __init__(self, g):
        self.g = g
        self.k = -1
        self.touched = []   # per staging drain: the rows it binned
        # (a row may repeat: the schedule hashes assign, so once counts)
        self.fired = []     # (staging drain, pool slab)

    def __enter__(self):
        from veneur_tpu_torch.core import tiered
        from veneur_tpu_torch.fleet import mesh_tiered

        self.mods = (tiered, mesh_tiered)
        real_apply = self.real_apply = tiered._pool_guard_apply
        g = self.g

        def apply(pool, *args):
            for i, p in enumerate(g.pools):
                if p is pool:
                    self.fired.append((self.k, i))
            return real_apply(pool, *args)

        def logged(real, rows, fill):
            def drain():
                self.k += 1
                self.touched.append(getattr(g, rows)[
                    :getattr(g, fill)].copy())
                return real()
            return drain

        for m in self.mods:
            m._pool_guard_apply = apply
        g._drain_samples = logged(g._drain_samples, "_rows", "_fill")
        g._drain_imports = logged(g._drain_imports, "_imp_rows",
                                  "_imp_fill")
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m._pool_guard_apply = self.real_apply
        del self.g._drain_samples, self.g._drain_imports

    def schedules(self, rows: np.ndarray, slab_rows: int) -> tuple:
        """Each series' drain schedule (``rows``: its row in this group),
        hashed: for each staging drain that binned its entries, in
        order, that drain's index and how many guard drains its slab
        took since the series' previous one (or since the interval
        began); then how many after its last. Returns (the hash of the
        staging drains alone, the hash of the whole schedule), one
        uint64 a series."""
        inv = np.full(int(rows.max()) + 1, -1, np.int64)
        inv[rows] = np.arange(len(rows))
        fired = np.zeros((len(self.g.pools), len(self.touched)), np.int64)
        for k, i in self.fired:
            fired[i, k] += 1
        cum = fired.cumsum(1)
        slab = rows // slab_rows
        mul = np.uint64(0x100000001B3)
        seen = np.zeros(len(rows), np.uint64)
        sched = np.zeros(len(rows), np.uint64)
        last = np.zeros(len(rows), np.int64)
        for k, touched in enumerate(self.touched):
            ser = inv[touched]
            now = cum[slab[ser], k]
            seen[ser] = seen[ser] * mul + np.uint64(k + 1)
            sched[ser] = (sched[ser] * mul + np.uint64(k + 1)) * mul + (
                now - last[ser]).astype(np.uint64)
            last[ser] = now
        sched = sched * mul + (cum[slab, -1] - last).astype(np.uint64)
        return seen, sched


def _mt_same_schedule(mesh_log, twin_log, rows_m, rows_t, gm, gt) -> tuple:
    """Which series took the same drain schedule in the mesh store and
    its twin. Both logs must bin each series in the same staging drains
    (the staging boundaries are the base class's in both). Returns (the
    mask over series, the count of staging drains, the guard drains of
    each)."""
    seen_m, sched_m = mesh_log.schedules(rows_m, gm.slab_rows)
    seen_t, sched_t = twin_log.schedules(rows_t, gt.slab_rows)
    if not np.array_equal(seen_m, seen_t):
        raise AssertionError("leg (c): the two stores' staging drains "
                             "binned different series")
    return (sched_m == sched_t, len(mesh_log.touched),
            [len(mesh_log.fired), len(twin_log.fired)])


def run_mesh_tiered(dev, series: int = FHA_MESH_SERIES,
                    slab_rows: int = 1 << 20) -> dict:
    """Leg (c): the mesh tiered store against its single-card twin (see
    phase_fleet_ha). Returns the record; the twin's launches do not
    count toward the main path's."""
    import torch

    from veneur_tpu_torch.core.store import MetricStore
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.parser import MetricKey

    rng = np.random.default_rng(SEED + 71)
    keys = [MetricKey(f"mt.{i}", "histogram", "") for i in range(series)]
    hot = np.arange(0, series, FHA_MESH_HOT_EVERY)
    kw = dict(initial_capacity=1024, chunk=FHA_MESH_CHUNK,
              digest_storage="tiered", slab_rows=slab_rows)
    mesh = MetricStore(mesh=_shard_mesh(dev), **kw)
    twin = MetricStore(device=dev, **kw)
    gm, gt = mesh.histograms, twin.histograms
    rec = {"series": series, "mesh": dict(mesh.mesh.shape),
           "pool_slab_rows": gm.slab_rows, "pool_centroids": gm.pk,
           "hot_series": len(hot), "chunk": FHA_MESH_CHUNK}
    qs = list(PERCENTILES)
    first = _first_launch(tc, "launch_compress_presorted", kernel_name=True)
    acc = dict.fromkeys(("mesh_rank_sum", "twin_rank_sum", "mesh_rank_max",
                         "twin_rank_max", "same_rel_max"), 0.0)
    acc.update(cells=0, mesh_worse=0, twin_worse=0)
    for interval in range(2):
        vals = rng.gamma(2.0, 10.0, (series, 8)).astype(np.float32)
        vals[:, 4:] += 1000.0  # the second half shifted: the guard drains
        hot_vals = rng.gamma(2.0, 10.0, (len(hot), FHA_MESH_HOT_SAMPLES)
                             ).astype(np.float32)
        imp = (500.0 + rng.gamma(2.0, 10.0, (series, 8))).astype(
            np.float32)
        tag = f"{interval}"
        with _PoolDrainLog(gm) as log_m:
            with mesh._lock:
                if first.call is None:
                    with first:
                        rows_m = _mt_feed(gm, keys, vals, hot, hot_vals,
                                          imp, rec, "mesh" + tag)
                else:
                    rows_m = _mt_feed(gm, keys, vals, hot, hot_vals, imp,
                                      rec, "mesh" + tag)
            _sync(dev)
            occ = gm.placement.occupancy()
            t0 = time.perf_counter()
            _, m = gm.flush(qs, want_digests=bool(interval),
                            want_stats=("pcts", "count"))
            rec[f"mesh{tag}_flush_s"] = time.perf_counter() - t0
        with _uncounted(tc), _PoolDrainLog(gt) as log_t:
            with twin._lock:
                rows_t = _mt_feed(gt, keys, vals, hot, hot_vals, imp, rec,
                                  "twin" + tag)
            _sync(dev)
            t0 = time.perf_counter()
            _, t = gt.flush(qs, want_digests=bool(interval),
                            want_stats=("pcts", "count"))
            rec[f"twin{tag}_flush_s"] = time.perf_counter() - t0
        rec[f"occupancy{tag}"] = occ["per_shard"]
        rec[f"balance_ratio{tag}"] = occ["balance_ratio"]
        want_count = 8.0 + np.isin(np.arange(series), hot) * float(
            FHA_MESH_HOT_SAMPLES)
        for r in (m, t):
            if not np.array_equal(r["count"], want_count):
                raise AssertionError(f"leg (c) interval {interval}: "
                                     "counts not exact")
        if interval:
            mass = [r["digest_weight"].sum(1, dtype=np.float64)
                    for r in (m, t)]
            want_mass = want_count + 8.0
            mass_err = max(float(np.max(np.abs(x - want_mass) / want_mass))
                           for x in mass)
            rec["mass_max_rel_err"] = mass_err
            if mass_err > 1e-6:
                raise AssertionError(f"leg (c): digest mass off by "
                                     f"{mass_err:.3g}")
            del mass, m["digest_mean"], m["digest_weight"]
            del t["digest_mean"], t["digest_weight"]
        # where a series took the same pool drain schedule in both (and
        # stayed in the pool: interval 2 promotes the hot series into
        # the bank), the design gives it the same digest: its
        # percentiles within rtol 1e-5 of the twin's. The rest took
        # their slab's drains at other points (the mesh's slabs hold
        # other series than the twin's): no worse than the twin's
        same, staged, fired = _mt_same_schedule(log_m, log_t, rows_m,
                                                rows_t, gm, gt)
        pooled = np.ones(series, bool)
        if interval:
            pooled[hot] = False
        eq = same & pooled
        pm, pt = m["percentiles"], t["percentiles"]
        rel = np.abs(pm - pt) / np.maximum(np.abs(pt), 1e-30)
        same_rel = float(rel[eq].max(initial=0.0))
        acc["same_rel_max"] = max(acc["same_rel_max"], same_rel)
        off = rel > 1e-5
        rec[f"schedule{tag}"] = {
            "staging_drains": staged, "guard_drains": fired,
            "same_series": int(eq.sum()),
            "other_series": int((~same & pooled).sum()),
            "promoted_series": int((~pooled).sum()),
            "same_max_rel_err": same_rel,
            "same_exact_share": float((pm[eq] == pt[eq]).mean()),
            "cells_past_rtol_1e_5": int(off.sum()),
            "cells_past_rtol_1e_5_other": int(off[~same & pooled].sum()),
            "cells_past_rtol_1e_5_promoted": int(off[~pooled].sum())}
        if same_rel > 1e-5:
            raise AssertionError(f"leg (c): series with the twin's drain "
                                 f"schedule differ: {rec}")
        cold = np.setdiff1d(np.flatnonzero(~eq), hot)
        hot_x = np.intersect1d(np.flatnonzero(~eq), hot)
        hot_at = np.searchsorted(hot, hot_x)
        for rows_, exact in (
                (cold, np.concatenate([vals[cold], imp[cold]], 1)),
                (hot_x, np.concatenate([vals[hot_x], hot_vals[hot_at],
                                        imp[hot_x]], 1))):
            if not len(rows_):
                continue
            exact.sort(1)
            em = _fha_rank_err(pm[rows_], exact, qs)
            et = _fha_rank_err(pt[rows_], exact, qs)
            gate = max(CAP_ENVELOPE, 2.0 / exact.shape[1])
            for key, x in (("mesh", em), ("twin", et)):
                acc[f"{key}_rank_sum"] += float(x.sum())
                acc[f"{key}_rank_max"] = max(acc[f"{key}_rank_max"],
                                             float(x.max()))
            acc["cells"] += em.size
            acc["mesh_worse"] += int((em - et > gate).sum())
            acc["twin_worse"] += int((et - em > gate).sum())
        del m, t, pm, pt, rel
    # the series whose schedules differ, and the promoted ones (the bank
    # bins a chunk's host slices apart): neither store the worse one
    # systematically: the mesh's mean rank error within 5% of the
    # twin's, and at most a share 1e-4 of the percentiles more than 0.15
    # of rank (bench.py 2g's envelope) worse than the twin's
    cells = max(acc["cells"], 1)
    mean_m = acc["mesh_rank_sum"] / cells
    mean_t = acc["twin_rank_sum"] / cells
    rec.update(other_mean_rank_err=[mean_m, mean_t],
               other_max_rank_err=[acc["mesh_rank_max"],
                                   acc["twin_rank_max"]],
               other_past_envelope_cells=[acc["mesh_worse"],
                                          acc["twin_worse"]],
               other_cells=acc["cells"],
               same_schedule_max_rel_err=acc["same_rel_max"],
               promotions=[gm.directory.promotions, gt.directory.promotions])
    if mean_m > 1.05 * mean_t + 1e-6 or \
            acc["mesh_worse"] > 1e-4 * cells:
        raise AssertionError(f"leg (c): the mesh's percentiles are worse "
                             f"than the twin's: {rec}")
    if gm.directory.promotions != \
            gt.directory.promotions or gm.directory.promotions == 0:
        raise AssertionError(f"leg (c): the mesh tiered store left its "
                             f"twin: {rec}")
    # the sharded pool's first compaction (K2 at merge width 32) on its
    # own inputs against its plain version, and the kernel it ran
    args, _ = first.call
    rec["pool_k2_rows"] = int(args[0].shape[0])
    rec["pool_k2_merge_width"] = 2 * tc.next_pow2(max(args[0].shape[1],
                                                      args[2].shape[1]))
    rec["pool_k2_max_abs_err"] = _hold_to_plain(
        tc, "the sharded pool compaction", first.call)
    rec["pool_k2_device_kernel"] = first.kernel
    if rec["pool_k2_max_abs_err"] != 0.0 or rec["pool_k2_merge_width"] \
            != 32 or (dev.type == "cuda" and "narrow_rows_kernelILi16E"
                      not in (first.kernel or "")):
        raise AssertionError(f"leg (c): the pool compaction {rec}")
    del first, mesh, twin, gm, gt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def run_mesh_tiered_server(dev, series: int = FHA_MESH_SERVER_SERIES
                           ) -> dict:
    """The mesh tiered Server (mesh_enabled, digest_storage tiered,
    4 x 2) boots, takes ``series`` histogram series x 8 samples over UDP
    and flushes: every count exact, every median inside its samples."""
    from veneur_tpu_torch.fleet.mesh_tiered import MeshTieredDigestGroup

    rng = np.random.default_rng(SEED + 73)
    vals = np.round(rng.gamma(2.0, 10.0, (series, 8)), 3)
    server, sink, _ = _fha_server(
        dev, "mt-server", mesh=_shard_mesh(dev), mesh_enabled=True,
        mesh_hosts=MESH_HOSTS, digest_storage="tiered",
        grpc_address="", native_import_address="")
    try:
        if not isinstance(server.store.histograms, MeshTieredDigestGroup):
            raise AssertionError("mesh + tiered did not build the mesh "
                                 "tiered store")
        lines = [f"mts.{i}:{v}|h" for i in range(series)
                 for v in vals[i].tolist()]
        t0 = time.perf_counter()
        _fha_udp(server, lines)
        rec = {"series": series, "udp_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        blocks, _ = _fha_rows(server, sink, 0)
        rec["flush_s"] = time.perf_counter() - t0
    finally:
        server.shutdown()
    names, m, sfx = blocks["mts"]
    col = {s: i for i, s in enumerate(sfx)}
    idx = np.array([int(nm.rsplit(".", 1)[1]) for nm in names])
    if len(idx) != series or not np.all(m[:, col[".count"]] == 8.0):
        counts = m[:, col[".count"]]
        bad = np.flatnonzero(counts != 8.0)
        raise AssertionError(
            f"the mesh tiered Server's counts: {len(idx)} series of "
            f"{series}, {len(bad)} counts off 8 (first "
            f"{[(int(idx[i]), float(counts[i])) for i in bad[:8]]}, "
            f"total {float(np.nansum(counts))} of {8.0 * series})")
    med = m[:, col[".50percentile"]]
    v = vals[idx]
    if not np.all((med >= v.min(1) - 1e-3) & (med <= v.max(1) + 1e-3)):
        raise AssertionError("a median outside its samples")
    return rec


def phase_fleet_ha(dev, card: str) -> dict:
    """The elastic and HA global tier on the card, three legs (one line
    each) and the mesh tiered Server; each leg resets the launch counts
    before it drives its path and reads them after. The launches of the
    twins (leg a's C, leg c's single-card store) and of the plain-version
    holds do not count. Returns the launch counts."""
    import torch

    from veneur_tpu_torch.ops import tdigest_cuda as tc

    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke_fha"
    counts = {}
    t_phase = time.perf_counter()
    for leg, run in (("handoff", lambda: run_fleet_handoff(dev, workdir)),
                     ("standby", lambda: run_standby_failover(dev, workdir)),
                     ("mesh_tiered", lambda: run_mesh_tiered(dev)),
                     ("mesh_tiered_server",
                      lambda: run_mesh_tiered_server(dev))):
        _peak_reset(dev)
        _reset_counts(tc)
        t0 = time.perf_counter()
        rec = run()
        c = _counts(tc)
        _add_counts(counts, c)
        rec.update(launches=c, peak_bytes=_peak_bytes(dev),
                   leg_s=time.perf_counter() - t0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        emit({"phase": "fleet_ha", "leg": leg, "card": card, **rec})
    emit({"phase": "fleet_ha", "card": card, "launches": counts,
          "phase_s": time.perf_counter() - t_phase})
    return counts


SX_SERIES = 1 << 20              # histogram series fed through the store
SX_TLS_SERIES = 1 << 16          # more over TLS, 4 samples each
SX_TLS_CONNS = 8
SX_RATE = 0.125                  # every TLS sample's rate: weight 8, so a
SX_SHIFT = 1000.0                # row's first two reach the shift guard's
SX_SPANS = 4096                  # minimum and its last two, shifted, trip it
SX_SAMPLED = 4096                # datapoints parsed back: their series
SX_TIMER = "sinks.indicator"
SX_SERVICE = "sinks-svc"         # our spans' service prefix (the server's
KF_SERIES = 1 << 14              # own flush spans reach the sinks too)
KF_COUNTERS = 1024
KF_RAWS = 256                    # events, and service checks
KF_SPANS = 1024
TLS_DIR = Path(__file__).resolve().parent / "tests" / "data" / "torch_tls"


class _SinkReceiver:
    """A stdlib HTTP server on 127.0.0.1 standing in for SignalFx's
    ingest API, Datadog's trace agent or LightStep's collector: it reads
    each body by its Content-Length, keeps (method, path, body) and
    answers 200."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        requests = self.requests = []
        lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def _take(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    requests.append((self.command, self.path, body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            do_POST = do_PUT = _take

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def bodies(self, path: str) -> list:
        return [b for _, p, b in list(self.requests) if p == path]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


class _FakeBroker:
    """Just enough Kafka (a copy of tests/test_kafka_faults.py's broker):
    Metadata v0 and Produce v0, every produced value recorded by topic."""

    def __init__(self, partitions: int = 2):
        from veneur_tpu_torch.sinks.kafka_wire import _Reader

        self._reader = _Reader
        self.partitions = partitions
        self.messages = []   # (topic, partition, value bytes)
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _recv_exact(conn, n):
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                raise ConnectionError
            data += chunk
        return data

    def _serve(self, conn):
        import struct

        try:
            while True:
                (size,) = struct.unpack(">i", self._recv_exact(conn, 4))
                r = self._reader(self._recv_exact(conn, size))
                api = r.i16()
                r.i16()  # api version
                corr = r.i32()
                r.string()  # client id
                if api == 3:
                    resp = self._metadata(r)
                elif api == 0:
                    resp = self._produce(r)
                    if resp is None:
                        continue  # acks=0: no response
                else:
                    break
                payload = struct.pack(">i", corr) + resp
                conn.sendall(struct.pack(">i", len(payload)) + payload)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            conn.close()

    def _metadata(self, r):
        import struct

        r.i32()  # topic count
        topic = r.string()
        out = struct.pack(">i", 1) + struct.pack(">i", 1)  # one broker: us
        host = b"127.0.0.1"
        out += struct.pack(">h", len(host)) + host
        out += struct.pack(">i", self.port)
        out += struct.pack(">i", 1) + struct.pack(">h", 0)  # one topic
        tb = topic.encode()
        out += struct.pack(">h", len(tb)) + tb
        out += struct.pack(">i", self.partitions)
        for pid in range(self.partitions):
            out += struct.pack(">hiiii", 0, pid, 1, 0, 0)
        return out

    def _produce(self, r):
        import struct

        acks = r.i16()
        r.i32()  # timeout
        r.i32()  # topic count
        topic = r.string()
        r.i32()  # partition count
        pid = r.i32()
        mset = r.take(r.i32())
        mr = self._reader(mset)
        mr.i64()  # offset
        mr.i32()  # message size
        crc = mr.i32() & 0xFFFFFFFF
        body_start = mr.pos
        mr.i16()  # magic and attributes
        klen = mr.i32()
        if klen > 0:
            mr.take(klen)
        value = mr.take(mr.i32())
        if crc != (zlib.crc32(mset[body_start:]) & 0xFFFFFFFF):
            raise ConnectionError("bad message CRC")
        self.messages.append((topic, pid, value))
        if acks == 0:
            return None
        tb = topic.encode()
        return (struct.pack(">i", 1) + struct.pack(">h", len(tb)) + tb
                + struct.pack(">iih", 1, pid, 0)
                + struct.pack(">q", len(self.messages)))

    def topic(self, name: str) -> list:
        return [v for t, _, v in list(self.messages) if t == name]

    def close(self):
        self._stop = True
        self._srv.close()


def _poll(cond, timeout: float, what: str) -> None:
    """:func:`_wait_for` for a condition that costs a scan: every 50 ms."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _sx_spans(n: int, seed: int) -> list:
    """``n`` valid indicator spans (port codec bytes) of SX_SERVICE's
    8 services, each its own trace, 1 us to 10 s long."""
    from veneur_tpu_torch.protocol import ssf

    rng = np.random.default_rng(seed)
    durs = (10 ** rng.uniform(3, 10, n)).astype(np.int64)
    out = []
    for i in range(n):
        start = 1_700_000_000_000_000_000 + i * 1000
        out.append(ssf.SSFSpan(
            version=1, trace_id=1 + i, id=1_000_000 + i, parent_id=0,
            start_timestamp=start, end_timestamp=start + int(durs[i]),
            error=bool(i % 2), service=f"{SX_SERVICE}{i % 8}",
            name=f"op.{i % 16}", indicator=True,
            tags={"resource": f"/r{i % 4}"}).SerializeToString())
    return out


def _send_spans(addr, spans) -> None:
    """SSF datagrams, paced (2 ms every 64): the C++ pool sheds a batch
    its pump has not swapped yet."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i, span in enumerate(spans):
            tx.sendto(span, addr)
            if i % 64 == 63:
                time.sleep(0.002)


def _tls_client(port: int, cert: str = ""):
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(str(TLS_DIR / "ca.crt"))
    if cert:
        ctx.load_cert_chain(str(TLS_DIR / f"{cert}.crt"),
                            str(TLS_DIR / f"{cert}.key"))
    raw = socket.create_connection(("127.0.0.1", port), timeout=30)
    return ctx.wrap_socket(raw, server_hostname="localhost")


def _refused(port: int, cert: str = "") -> bool:
    """A client the listener must refuse: its handshake or its first read
    fails, and nothing it sent may count."""
    import ssl

    try:
        conn = _tls_client(port, cert)
        conn.sendall(b"sx.refused:1|c\n")
        conn.settimeout(10)
        died = conn.recv(1) == b""
        conn.close()
        return died
    except (ssl.SSLError, OSError):
        return True


def _sx_tls_traffic(series: int, seed: int) -> dict:
    """The TLS series' samples (k/16 values: exact in float32 and in the
    lines' 4 decimals; the last two shifted +SX_SHIFT) and their lines,
    by connection and round: every 16th series carries drop_me."""
    rng = np.random.default_rng(seed)
    vals = np.round(rng.gamma(2.0, 10.0, (series, 4)) * 16.0) / 16.0
    vals[:, 2:] += SX_SHIFT
    rounds = [[[] for _ in range(SX_TLS_CONNS)] for _ in range(2)]
    for i in range(series):
        tags = f"k:v{i % 4}" + (",drop_me:x" if i % 16 == 0 else "")
        for j in range(4):
            rounds[j // 2][i % SX_TLS_CONNS].append(
                f"sx.t.{i}:{vals[i, j]:.4f}|h|@{SX_RATE}|#{tags}")
    return {"vals": vals, "rounds": [[("\n".join(c) + "\n").encode()
                                      for c in r] for r in rounds]}


def _sfx_datapoints(bodies) -> int:
    """Datapoints in SignalFx bodies by a byte scan: the C++ serializer's
    and json.dumps' spellings of a datapoint's first key."""
    return sum(b.count(b'{"metric":"') + b.count(b'{"metric": "')
               for b in bodies)


def _check_sfx_sample(col, bodies, hostname: str, rec) -> None:
    """SX_SAMPLED histogram series' datapoints, found by position in
    their block's body (gauges, then counters, each in emission order)
    and parsed back: each equals its emission (name and suffix, value,
    the flush's timestamp in ms) and carries the host dimension and the
    series' tags but drop_me."""
    from veneur_tpu_torch.core.columnar import TYPE_COUNTER, arena_strings

    blk = max(col.blocks, key=len)
    body = next(b for b in bodies if _sfx_datapoints([b]) == len(blk))
    starts = np.flatnonzero(np.frombuffer(body, np.uint8) == ord("{"))
    starts = starts[starts + 10 < len(body)]
    arr = np.frombuffer(body, np.uint8)
    starts = starts[(arr[starts + 1] == ord('"'))
                    & (arr[starts + 2] == ord("m"))]
    if len(starts) != len(blk):
        raise AssertionError(f"{len(starts)} datapoints in the body of a "
                             f"{len(blk)}-row block")
    counter = blk.type_codes == TYPE_COUNTER
    pos = np.empty(len(blk), np.int64)
    pos[~counter] = np.arange(int((~counter).sum()))
    pos[counter] = int((~counter).sum()) + np.arange(int(counter.sum()))
    names, tags = arena_strings(blk.names), arena_strings(blk.tags)
    rng = np.random.default_rng(SEED + 181)
    rows = set(rng.choice(len(names), min(SX_SAMPLED, len(names)),
                          replace=False).tolist())
    checked = 0
    for e in np.flatnonzero(np.isin(blk.rows, list(rows))):
        a = int(starts[pos[e]])
        dp = json.loads(body[a:body.index(b"}}", a) + 2])
        r = int(blk.rows[e])
        want_dims = {"host": hostname}
        want_dims.update(t.split(":", 1) for t in tags[r].split(",")
                         if t and not t.startswith("drop_me:"))
        want_value = (int(blk.values[e]) if counter[e]
                      else float(blk.values[e]))
        got = (dp["metric"], dp["value"], dp["timestamp"], dp["dimensions"])
        want = (names[r] + blk.suffixes[blk.suffix_idx[e]].decode(),
                want_value, col.timestamp * 1000, want_dims)
        if got != want:
            raise AssertionError(f"datapoint {got} is not {want}")
        checked += 1
    rec.update(sampled_series=len(rows), sampled_datapoints=checked)


def _check_tls_rows(col, vals, rec) -> None:
    """The TLS series' rows against what they were sent: counts exact
    (4 samples of weight 8), min and max exact, the percentiles within
    0.02 x (max - min) of the exact digest of the samples."""
    from veneur_tpu_torch.core.columnar import arena_strings

    blk = max(col.blocks, key=len)
    mat = _block_matrix(blk)
    row_of = {n: r for r, n in enumerate(arena_strings(blk.names))
              if n.startswith("sx.t.")}
    if len(row_of) != len(vals):
        raise AssertionError(f"{len(row_of)} TLS series flushed of "
                             f"{len(vals)}")
    sfx = [b".max", b".min", b".count"] + [
        f".{int(p * 100)}percentile".encode() for p in INGEST_PERCENTILES]
    if blk.suffixes != sfx:
        raise AssertionError(f"histogram suffixes {blk.suffixes}")
    sel = mat[[row_of[f"sx.t.{i}"] for i in range(len(vals))]]
    samples = vals.astype(np.float32)
    if not (np.array_equal(sel[:, 0], samples.max(1))
            and np.array_equal(sel[:, 1], samples.min(1))
            and np.all(sel[:, 2] == 4.0 / SX_RATE)):
        raise AssertionError("the TLS series' min, max or count are off")
    want = np.stack([_digest_reference(row, INGEST_PERCENTILES)
                     for row in samples])
    span = (samples.max(1) - samples.min(1)).astype(np.float64)
    worst = float(np.max(np.abs(sel[:, 3:] - want) / span[:, None]))
    if worst > 0.02:
        raise AssertionError(f"the TLS series' percentiles are "
                             f"{worst:.3g} of the span off")
    rec["tls_pct_err_vs_exact_digest"] = worst


def run_sinks_tls(dev, series: int = SX_SERIES,
                  tls_series: int = SX_TLS_SERIES,
                  spans_n: int = SX_SPANS) -> tuple:
    """Leg (a) of the sinks phase: one port Server configured through
    sinks/factory.py from a Config (a TLS statsd listener with client
    certificates required, on the C++ rung; an SSF listener; SignalFx,
    Datadog's trace agent, LightStep and Falconer, each an in-process
    receiver) takes ``series`` histogram series through its store,
    ``tls_series`` x 4 samples over SX_TLS_CONNS TLS connections (the
    guard drains through K2 on the TLS pump's thread), refuses an
    anonymous client and one with an untrusted certificate, and takes
    ``spans_n`` indicator spans; one flush (K1). Returns the record and
    the launch counts."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.samplers.parser import MetricKey
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.factory import create_sinks
    from veneur_tpu_torch.sinks.grpsink import SpanSinkServer

    rec = {"histogram_series": series, "tls_series": tls_series,
           "spans": spans_n}
    sfx, agent, ls = _SinkReceiver(), _SinkReceiver(), _SinkReceiver()
    falconer = SpanSinkServer()
    falconer.start("127.0.0.1:0")
    cfg = Config(
        statsd_listen_addresses=["tcp://127.0.0.1:0"],
        ssf_listen_addresses=["udp://127.0.0.1:0"],
        tls_certificate=str(TLS_DIR / "server.crt"),
        tls_key=str(TLS_DIR / "server.key"),
        tls_authority_certificate=str(TLS_DIR / "ca.crt"),
        native_ingest=True, indicator_span_timer_name=SX_TIMER,
        span_channel_capacity=4096, max_series=INGEST_MAX_SERIES,
        interval="86400s", percentiles=list(INGEST_PERCENTILES),
        aggregates=["min", "max", "count"], hostname="sinks-host",
        signalfx_api_key="sfx-key", signalfx_endpoint_base=sfx.url,
        tags_exclude=["drop_me"], datadog_trace_api_address=agent.url,
        lightstep_collector_host=ls.url, lightstep_access_token="ls-token",
        lightstep_maximum_spans=2 * spans_n,
        falconer_address=f"127.0.0.1:{falconer.port}")
    sinks, span_sinks, plugins = create_sinks(cfg)
    rec["sinks"] = [s.name for s in sinks]
    rec["span_sinks"] = [s.name for s in span_sinks]
    if rec["sinks"] != ["signalfx"] or rec["span_sinks"] != [
            "datadog", "lightstep", "falconer"] or plugins:
        raise AssertionError(f"the factory built {rec}")
    sfx_sink = sinks[0]
    telemetry = []
    drain = sfx_sink.drain_flush_telemetry

    def keep_telemetry():
        out = drain()
        telemetry.extend(out)
        return out

    sfx_sink.drain_flush_telemetry = keep_telemetry
    recorder = _ColumnarRecorder()
    server = Server(cfg, metric_sinks=sinks + [recorder],
                    span_sinks=span_sinks, device=dev)
    server.start()
    try:
        rungs = [r for _, r, _ in server.listeners]
        rec["listener_rung"] = rungs
        if rungs != ["native"]:
            raise AssertionError(f"the TLS listener took the {rungs} rung")
        reader = server.native_readers[0]
        port = server.statsd_addrs[0][1]
        vals_bulk = np.random.default_rng(SEED + 173).gamma(
            2.0, 10.0, (series, 4)).astype(np.float32)
        traffic = _sx_tls_traffic(tls_series, SEED + 179)
        spans = _sx_spans(spans_n, SEED + 191)
        _reset_counts(tc)
        store = server.store
        t0 = time.perf_counter()
        with store._lock:
            hist = store.histograms
            rows = np.array([hist.interner.intern(
                MetricKey(f"sx.h.{i}", "histogram", ""), [])
                for i in range(series)], np.int32)
            hist.ensure_capacity(int(rows.max()))
            hist.sample_many(np.repeat(rows, 4), vals_bulk.reshape(-1),
                             np.ones(vals_bulk.size, np.float32))
        _sync(dev)
        rec["bulk_feed_s"] = time.perf_counter() - t0
        # the refused clients first: nothing of theirs may count
        if not (_refused(port) and _refused(port, "rogue")):
            raise AssertionError("a client without a trusted certificate "
                                 "kept its connection")
        c_tls0 = _counts(tc)
        conns = [_tls_client(port, "client") for _ in range(SX_TLS_CONNS)]
        p0, t0 = store.processed, time.perf_counter()
        for rnd in range(2):
            threads = [threading.Thread(target=c.sendall, args=(data,))
                       for c, data in zip(conns, traffic["rounds"][rnd])]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            _wait_processed(server, p0 + 2 * tls_series * (rnd + 1), 300)
        rec["tls_s"] = time.perf_counter() - t0
        rec["tls_lines_per_s"] = 4 * tls_series / rec["tls_s"]
        for c in conns:
            c.close()
        rec["tls_launches"] = _delta(_counts(tc), c_tls0)
        rec.update(tls_conns=reader.conns(),
                   tls_handshake_failures=reader.handshake_failures(),
                   tls_drops=reader.drops())
        if (reader.handshake_failures() != 2
                or reader.conns() - reader.handshake_failures()
                != SX_TLS_CONNS or reader.drops()):
            raise AssertionError(f"TLS connections: {rec}")
        if store.processed != p0 + 4 * tls_series:
            raise AssertionError("a refused client's line was counted")
        # after the feed and the TLS traffic: the Falconer lane's gRPC call
        # a span, beside the interning loop, slows both by contention
        t_spans = time.perf_counter()
        _send_spans(server.ssf_addrs[0], spans)

        def ours(spans_seen):
            return sum(1 for s in spans_seen
                       if s.service.startswith(SX_SERVICE))

        _poll(lambda: ours(falconer.spans) >= spans_n, 120,
                  "the spans at the Falconer receiver")
        rec["spans_in_s"] = time.perf_counter() - t_spans
        c_flush = _counts(tc)
        t0 = time.perf_counter()
        server.flush()
        col = recorder.flushes.get(timeout=600)
        rec["flush_s"] = time.perf_counter() - t0
        rec["flush_launches"] = _delta(_counts(tc), c_flush)
        counts = _counts(tc)
        rows_flushed = sum(len(b) for b in col.blocks) + len(col.extras)
        # the sink's POSTs end before the flush returns unless its
        # fan-out join gave up on them
        _poll(lambda: _sfx_datapoints(sfx.bodies("/v2/datapoint"))
                  >= rows_flushed, 120, "the SignalFx datapoints")
        bodies = sfx.bodies("/v2/datapoint")
        dps = _sfx_datapoints(bodies)
        rec.update(sfx_bodies=len(bodies),
                   sfx_body_bytes=sum(len(b) for b in bodies),
                   sfx_datapoints=dps, rows_flushed=rows_flushed,
                   sfx_telemetry={k: sum(v for kk, v in telemetry
                                         if kk == k)
                                  for k in ("marshal_s", "post_s")})
        if dps != rows_flushed:
            raise AssertionError(f"SignalFx counted {dps} datapoints, the "
                                 f"flush has {rows_flushed} rows")
        if any(b'"drop_me"' in b for b in bodies):
            raise AssertionError("a datapoint carries drop_me")
        _check_sfx_sample(col, bodies, cfg.hostname, rec)
        _check_tls_rows(col, traffic["vals"], rec)
        rec["indicator_timer_rows"] = sum(
            int(np.array([x.startswith(SX_TIMER) for x in _arena(b.names)],
                         bool)[b.rows].sum()) for b in col.blocks)
        # every span at every span sink (the Datadog ring PUT by the span
        # flush, LightStep's reporter within its 1 s cadence)
        seen = {"falconer": sorted(s.id for s in falconer.spans
                                   if s.service.startswith(SX_SERVICE))}

        def agent_ids():
            return sorted(s["span_id"] for b in agent.bodies("/v0.3/traces")
                          for t in json.loads(b) for s in t
                          if s["service"].startswith(SX_SERVICE))

        def ls_ids():
            return sorted(s["span_id"]
                          for b in ls.bodies("/api/v2/reports")
                          for s in json.loads(b)["spans"]
                          if s["tags"]["component"].startswith(SX_SERVICE))

        _poll(lambda: len(agent_ids()) >= spans_n
                  and len(ls_ids()) >= spans_n, 60, "the span sinks")
        seen.update(datadog=agent_ids(), lightstep=ls_ids())
        want_ids = [1_000_000 + i for i in range(spans_n)]
        rec["spans_at"] = {k: len(v) for k, v in seen.items()}
        if any(v != want_ids for v in seen.values()):
            raise AssertionError(f"spans at the sinks: {rec['spans_at']}")
        if dev.type == "cuda" and not (
                rec["tls_launches"].get("compress_presorted.launches", 0)
                >= 1 and rec["flush_launches"].get(
                    "drain_quantile.launches", 0) >= 1):
            raise AssertionError(f"K2 on the TLS pump {rec['tls_launches']}"
                                 f", K1 at the flush "
                                 f"{rec['flush_launches']}")
        del col, bodies
    finally:
        server.shutdown()
        falconer.stop()
        for r in (sfx, agent, ls):
            r.close()
    return rec, counts


def _arena(arenas) -> list:
    from veneur_tpu_torch.core.columnar import arena_strings

    return arena_strings(arenas)


def run_sinks_kafka(dev, series: int = KF_SERIES,
                    counters: int = KF_COUNTERS, raws: int = KF_RAWS,
                    spans_n: int = KF_SPANS) -> tuple:
    """Leg (b): a port Server configured through the factory with the
    Kafka metric sink (metric, check and event topics) and the Kafka
    span sink (SSF protobuf), producing through the stdlib wire producer
    into an in-process broker; ``series`` histogram series x 4 samples,
    ``counters`` counters, ``raws`` events and service checks over
    plain tcp:// (the C++ rung) and ``spans_n`` spans; one flush (K1).
    Held: the metric topic holds every row of the flush, service
    checks' status rows included, each message the row's JSON; the
    check and event topics hold nothing (the sink produces every row to
    the metric topic and ignores events, as the JAX package and the
    reference do) while the flush carried the events; each span message
    decodes to the span sent. Returns the record and the launch
    counts."""
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.protocol import ssf
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks.factory import create_sinks

    broker = _FakeBroker()
    cfg = Config(
        statsd_listen_addresses=["tcp://127.0.0.1:0"],
        ssf_listen_addresses=["udp://127.0.0.1:0"], native_ingest=True,
        span_channel_capacity=4096, interval="86400s", percentiles=[0.99],
        aggregates=["count"], hostname="kafka-host",
        kafka_broker=f"127.0.0.1:{broker.port}", kafka_metric_topic="m",
        kafka_check_topic="c", kafka_event_topic="e", kafka_span_topic="s",
        kafka_metric_require_acks="local", kafka_span_require_acks="local")
    sinks, span_sinks, _ = create_sinks(cfg)
    if [s.name for s in sinks + span_sinks] != ["kafka", "kafka"]:
        raise AssertionError("the factory built no Kafka sinks")
    recorder = _ColumnarRecorder()
    server = Server(cfg, metric_sinks=sinks + [recorder],
                    span_sinks=span_sinks, device=dev)
    server.start()
    rec = {"histogram_series": series, "counters": counters,
           "events": raws, "checks": raws, "spans": spans_n}
    try:
        if [r for _, r, _ in server.listeners] != ["native"]:
            raise AssertionError(f"the TCP listener: {server.listeners}")
        rng = np.random.default_rng(SEED + 197)
        vals = np.round(rng.gamma(2.0, 10.0, (series, 4)) * 16.0) / 16.0
        lines = [f"kf.h.{i}:{v:.4f}|h" for i in range(series)
                 for v in vals[i]]
        lines += [f"kf.c.{i}:{i + 1}|c|#k:v" for i in range(counters)]
        lines += [f"_e{{4,{len(str(i))}}}:ev.{i % 10}|{i}|#k:e"
                  for i in range(raws)]
        lines += [f"_sc|kf.check.{i}|{i % 4}|m:m{i}" for i in range(raws)]
        spans = _sx_spans(spans_n, SEED + 199)
        _reset_counts(tc)
        t0 = time.perf_counter()
        with socket.create_connection(server.statsd_addrs[0], 30) as conn:
            conn.sendall(("\n".join(lines) + "\n").encode())
        # events go to the event worker, not the store
        _wait_processed(server, len(lines) - raws, 300)
        _send_spans(server.ssf_addrs[0], spans)
        _poll(lambda: sum(1 for v in broker.topic("s")
                              if ssf.decode_span(v).service.startswith(
                                  SX_SERVICE)) >= spans_n, 120,
                  "the span messages")
        rec["ingest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        server.flush()
        col = recorder.flushes.get(timeout=600)
        events = recorder.events.get(timeout=60)
        rows = col.to_intermetrics()
        _poll(lambda: len(broker.topic("m")) >= len(rows), 300,
                  "the metric messages")
        rec["flush_and_produce_s"] = time.perf_counter() - t0
        counts = _counts(tc)
        got = sorted(broker.topic("m"))
        want = sorted(json.dumps({
            "name": m.name, "timestamp": m.timestamp, "value": m.value,
            "tags": m.tags, "type": m.type.value, "message": m.message,
            "hostname": m.hostname}).encode() for m in rows)
        mine = sorted((span.id, v) for v, span in (
            (v, ssf.decode_span(v)) for v in broker.topic("s"))
            if span.service.startswith(SX_SERVICE))
        status = sum(1 for m in rows if m.type.value == "status")
        rec.update(rows_flushed=len(rows), status_rows=status,
                   events_flushed=len(events),
                   messages={t: len(broker.topic(t))
                             for t in ("m", "c", "e", "s")},
                   produce_errors=sum(getattr(s, "flush_errors", 0)
                                      for s in sinks),
                   metrics_flushed=sinks[0].metrics_flushed)
        if got != want or status != raws or len(events) != raws:
            raise AssertionError(f"the metric topic differs from the rows: "
                                 f"{rec}")
        if broker.topic("c") or broker.topic("e"):
            raise AssertionError("a message on the check or event topic")
        if [m for _, m in mine] != spans or [i for i, _ in mine] != [
                1_000_000 + i for i in range(spans_n)]:
            raise AssertionError("the span messages differ from the spans")
        if dev.type == "cuda" and counts.get(
                "drain_quantile.launches", 0) < 1:
            raise AssertionError(f"no K1 at the Kafka Server's flush: "
                                 f"{counts}")
    finally:
        server.shutdown()
        broker.close()
    return rec, counts


def phase_sinks(dev, card: str) -> dict:
    """The remaining sinks and the TLS listener at full width (leg (a),
    run_sinks_tls, then leg (b), run_sinks_kafka): one line. Returns the
    launch counts of both legs."""
    _peak_reset(dev)
    t0 = time.perf_counter()
    tls, counts = run_sinks_tls(dev)
    gc.collect()
    kafka, kcounts = run_sinks_kafka(dev)
    emit({"phase": "sinks", "card": card, "tls_and_signalfx": tls,
          "kafka": kafka, "phase_s": time.perf_counter() - t0,
          "max_memory_allocated": _peak_bytes(dev)})
    return _add_counts(counts, kcounts)


def _late_capture(dev, seconds: float = 1.0) -> dict:
    """A 1 s profiler capture at the end of the script (obs/kernels.py
    capture_xprof) while another thread launches K2 (uncounted): whether
    it holds device events. Not a check: the question of the traces late
    in the script that held none stays open when it does not."""
    import torch

    from veneur_tpu_torch.obs import kernels as obs_kernels
    from veneur_tpu_torch.ops import tdigest_cuda as tc

    stop = threading.Event()
    ka = _k2_inputs(dev)

    def launch():
        while not stop.is_set():
            tc.compress_presorted(*ka, COMPRESSION, ka[0].shape[-1])
            torch.cuda.synchronize(dev)
            time.sleep(0.01)

    with _uncounted(tc):
        th = threading.Thread(target=launch)
        th.start()
        try:
            status, body, _ = obs_kernels.capture_xprof(seconds)
        finally:
            stop.set()
            th.join()
    if status != 200:
        return {"status": status, "error": body}
    data = json.loads(body)
    with open(data["files"][0]["path"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {"status": status, "seconds": data["seconds"],
            "device_events": len(kernels),
            "kernels": sorted(set(k[:60] for k in kernels))[:4]}


def _ptxas_summary(logs) -> list:
    """Registers, spills and shared memory of every kernel instance, from
    nvcc's -Xptxas -v output: warp<half,sort_b,drain> / narrow<...> /
    block<...>."""
    out, cur = [], None
    for text in logs.values():
        for ln in text.splitlines():
            hit = re.search(r"Compiling entry function '(\w+)'", ln)
            if hit:
                t = re.search(r"(warp|narrow|block)_rows_kernelI"
                              r"(?:Li(\d+)E)?Lb(\d)ELb(\d)E", hit.group(1))
                cur = {"fn": (f"{t.group(1)}<{t.group(2) or 'any'},"
                              f"sort_b={t.group(3)},drain={t.group(4)}>"
                              if t else hit.group(1))}
                out.append(cur)
            elif cur is not None:
                for key, pat in (("spill_stores", r"(\d+) bytes spill st"),
                                 ("spill_loads", r"(\d+) bytes spill lo"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem", r"(\d+) bytes smem")):
                    got = re.search(pat, ln)
                    if got:
                        cur[key] = int(got.group(1))
    return out


def _kernel_rows(kern: dict, launches: dict) -> list:
    """The final kernels line's rows from the kernels phase's records, the
    main path's launch counts and the records later phases left."""
    src = "veneur_tpu_torch/csrc/tdigest_merge.cu"
    # K1 and K2 with the b half presorted (the main path), then K3: the
    # sort_b mode of each, which no production path runs; then K2 in the
    # mesh's butterfly round (both halves ascending, K wide), whose
    # launches are its own (part of K2's)
    specs = []
    for name, key, line, counter in (
            ("drain_quantile", "drain_quantile", 334, "launches"),
            ("compress_presorted", "compress_presorted", 419, "launches"),
            ("drain_quantile sort_b", "sort_b_drain_quantile", 97,
             "sort_b_launches"),
            ("compress_presorted sort_b", "sort_b_compress_presorted", 97,
             "sort_b_launches")):
        k, wide = kern[key], kern["wide_" + key]
        specs.append((name, line, dict(
            launches=launches[f"{name.split()[0]}.{counter}"],
            max_abs_err=max(k["max_abs_err"], wide["max_abs_err"]),
            **{f: k[f] for f in ("ms", "plain_ms", "bound_ms",
                                 "bound_by")})))
    fly = _RECORDS["mesh_butterfly"]
    specs.append(("compress_presorted butterfly", 419, {
        f: fly[f] for f in ("launches", "max_abs_err", "ms", "plain_ms",
                            "bound_ms", "bound_by")}))
    # the narrow path at merge widths 32 and 16 and the general path at
    # compression 1000, each with the launches of its path's counter (a
    # share of its kernel's row above); K2 at width 32 is timed on the
    # pool compaction's own inputs (the capacity phase)
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for label, counter, what in (("w32_", "narrow32_launches", "width 32"),
                                 ("w16_", "narrow16_launches", "width 16"),
                                 ("wide_", "general_launches",
                                  "general path")):
        for name, line in (("drain_quantile", 334),
                           ("compress_presorted", 419)):
            rec = {f: kern[label + name][f] for f in timed}
            rec["max_abs_err"] = max(
                rec["max_abs_err"], kern[f"{label}sort_b_{name}"][
                    "max_abs_err"])
            if (label, name) == ("w32_", "compress_presorted"):
                pool = _RECORDS["pool_k2_w32"]
                rec.update(pool, max_abs_err=max(rec["max_abs_err"],
                                                 pool["max_abs_err"]))
            specs.append((f"{name} {what}", line, dict(
                launches=launches[f"{name}.{counter}"], **rec)))
    rows = [{"name": name, "route": "cuda", "source": src,
             "replaces": f"veneur_tpu/ops/tdigest_pallas.py:{line}",
             **vals, "library_ms": None} for name, line, vals in specs]
    return rows


LC_SERIES = 1 << 20              # leg (a): histogram series through the store
LC_SAMPLED = 4096                # leg (a): series held to the exact digest
LC_PCTS = (0.5, 0.99)            # leg (a): before the reload
LC_RELOAD_PCTS = (0.5, 0.9, 0.99, 0.999)
LC_CLI_SERIES = 1 << 16          # leg (b): counter and histogram series
LC_CLI_PCTS = (0.5, 0.99)        # leg (b): generation 1's file, then
LC_CLI_HUP_PCTS = (0.5, 0.9, 0.99)   # after its SIGHUP
LC_CLI_INTERVAL_S = 600.0        # leg (b): no tick flush; a Datadog rate
LC_GEN2_HISTS = 4096             # leg (b): histogram series to generation 2
LC_PROM_FAMILIES = 1000          # leg (b): the scraped exposition
LC_FWD_SERIES = 1 << 16          # leg (c): histogram series a local
LC_FWD_SEED = 3                  # its schedule: 2 faults, then a delivery
LC_INGEST_DGRAMS = 1 << 16       # leg (c): datagrams on the per-line path
LC_INGEST_SERIES = 4096
LC_INGEST_SEED = 11
LC_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_lc"

_STARTUP_PROBE = r"""
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
from veneur_tpu_torch.ops import tdigest_cuda
tdigest_cuda._kernel_lib()
t3 = time.perf_counter()
from veneur_tpu_torch import native
from veneur_tpu_torch.native import egress
assert native.available() and egress.available()
t4 = time.perf_counter()
print(json.dumps({"torch_import_s": t1 - t0, "cuda_context_s": t2 - t1,
                  "kernel_library_s": t3 - t2,
                  "native_libraries_s": t4 - t3}))
"""


def _dd_series(recv, take: bool = True) -> list:
    """Every series entry the receiver's /api/v1/series bodies hold, in
    arrival order (each body inflated and parsed); ``take`` empties the
    receiver's list."""
    bodies = list(recv.bodies)
    if take:
        del recv.bodies[:len(bodies)]
    return [s for path, raw, enc in bodies if path == "/api/v1/series"
            for s in json.loads(zlib.decompress(raw) if enc == "deflate"
                                else raw)["series"]]


def _dd_scan(recv, needles) -> dict:
    """Occurrences of each byte string in the receiver's inflated series
    bodies, and the series count (``{"metric":``), without parsing them;
    empties the receiver."""
    bodies = list(recv.bodies)
    del recv.bodies[:len(bodies)]
    out = dict.fromkeys(needles, 0)
    out[b'{"metric":'] = 0
    for path, raw, enc in bodies:
        if path != "/api/v1/series":
            continue
        body = zlib.decompress(raw) if enc == "deflate" else raw
        for k in out:
            out[k] += body.count(k)
    return out


def _lc_block(col, prefix: str, matrix=None):
    """The ColumnarFlush block holding the series that start with
    ``prefix`` (the server's own veneur.* rows may share it): the block,
    those series' names, and their rows of ``matrix(block)``
    (``_block_matrix`` by default)."""
    from veneur_tpu_torch.core.columnar import arena_strings

    for blk in col.blocks:
        names = arena_strings(blk.names)
        rows = [r for r, n in enumerate(names) if n.startswith(prefix)]
        if rows:
            mat = (matrix or _block_matrix)(blk)[rows]
            return blk, [names[r] for r in rows], mat
    raise AssertionError(f"no block of {prefix}* series in the flush")


def _lc_feed(server, prefix: str, vals: np.ndarray, weight: float = 1.0):
    """``vals`` [S, n] into ``server``'s histogram group as S series
    ``<prefix><i>`` through the store, in bulk (run_fleet_trace's feed);
    returns the seconds it took, synchronised."""
    from veneur_tpu_torch.samplers.parser import MetricKey

    store = server.store
    t0 = time.perf_counter()
    with store._lock:
        hist = store.histograms
        rows = np.array([hist.interner.intern(
            MetricKey(f"{prefix}{i}", "histogram", ""), [])
            for i in range(len(vals))], np.int32)
        hist.ensure_capacity(int(rows.max()))
        hist.sample_many(np.repeat(rows, vals.shape[1]),
                         vals.reshape(-1).astype(np.float32),
                         np.full(vals.size, weight, np.float32))
    _sync(server.store.device)
    return time.perf_counter() - t0


def run_lifecycle_reload(dev, series: int = LC_SERIES,
                         sampled: int = LC_SAMPLED) -> tuple:
    """Leg (a): one port Server on ``dev`` built from a Config through
    sinks/factory.py, a Datadog sink at in-process receiver A with
    percentiles 0.5 and 0.99. ``series`` histogram series of 4
    gamma(2, 10) samples through its store, one flush (K1) to A; then
    ``Server.reload`` with four percentiles, one more global tag, the
    Datadog sink at receiver B and a changed tdigest_compression (a
    frozen key: it warns and keeps its value); the same series again
    and one flush (K1, taking the new percentile count). Held: B gets
    every row of the second flush, the four percentile columns on every
    series and the new tag on every row, A nothing after the reload;
    ``sampled`` series' percentiles within 0.02 x (max - min) of the
    exact digest of their samples (their rank error against np.quantile
    printed); A's sink retired at the reload and closed at the next
    one, not before; the statsd socket the same. Returns the record and
    the launch counts of the two flushes."""
    import logging

    from veneur_tpu_torch import flusher
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server
    from veneur_tpu_torch.sinks import factory

    rng = np.random.default_rng(SEED + 91)
    vals = rng.gamma(2.0, 10.0, (series, 4)).astype(np.float32)
    recv_a, recv_b = _DatadogReceiver(), _DatadogReceiver()

    def config(url, pcts, tags, compression=COMPRESSION):
        return Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                      interval="86400s", percentiles=list(pcts),
                      aggregates=["count"], tags=tags, hostname="lc",
                      datadog_api_key="k", datadog_api_hostname=url,
                      max_series=INGEST_MAX_SERIES,
                      tdigest_compression=compression)

    first = config(recv_a.url, LC_PCTS, ["env:lc"])
    record = _ColumnarRecorder()
    server = Server(first, metric_sinks=[record], device=dev,
                    config_sinks=factory.create_sinks(first))
    warned = []
    catch = logging.Handler(logging.WARNING)
    catch.emit = lambda r: warned.append(r.getMessage())
    logging.getLogger("veneur.server").addHandler(catch)
    rec = {"series": series, "percentiles_before": list(LC_PCTS),
           "percentiles_after": list(LC_RELOAD_PCTS)}
    counts = {}

    def flush():
        _reset_counts(tc)
        t0 = time.perf_counter()
        flusher.flush_once(server)
        col = record.flushes.get(timeout=600)
        wall = time.perf_counter() - t0
        _add_counts(counts, _counts(tc))
        return col, wall

    try:
        server.start()
        addr = server.statsd_addrs[0]
        rec["feed1_s"] = _lc_feed(server, "lc.h.", vals)
        col1, rec["flush1_s"] = flush()
        blk1, names1, _ = _lc_block(col1, "lc.h.")
        want1 = [b".count"] + [f".{int(p * 100)}percentile".encode()
                               for p in LC_PCTS]
        if blk1.suffixes != want1 or len(names1) != series:
            raise AssertionError(f"flush 1: suffixes {blk1.suffixes}")
        got_a = _dd_scan(recv_a, [b'{"metric":"lc.h.'])
        if got_a[b'{"metric":"lc.h.'] != series * len(want1):
            raise AssertionError(f"receiver A got {got_a} before the "
                                 f"reload")
        rec["flush1_series_at_a"] = got_a[b'{"metric":']
        old = next(s for s in server.metric_sinks if s.name == "datadog")
        closed = []
        old.close = lambda: closed.append(time.perf_counter())
        new = config(recv_b.url, LC_RELOAD_PCTS, ["env:lc", "reload:2"],
                     compression=COMPRESSION / 2)
        t0 = time.perf_counter()
        server.reload(new)
        rec["reload_s"] = time.perf_counter() - t0
        if (server.config.tdigest_compression != COMPRESSION
                or not any("tdigest_compression" in w for w in warned)):
            raise AssertionError("the frozen tdigest_compression changed "
                                 "or did not warn")
        if server.statsd_addrs[0] != addr or old not in \
                server._retired_sinks or closed:
            raise AssertionError("the reload moved the socket or closed "
                                 "A's sink early")
        rec["feed2_s"] = _lc_feed(server, "lc.h.", vals)
        col2, rec["flush2_s"] = flush()
        blk2, names2, mat = _lc_block(col2, "lc.h.")
        want2 = [b".count"] + [f".{int(p * 100)}percentile".encode()
                               for p in LC_RELOAD_PCTS]
        if blk2.suffixes != want2 or len(names2) != series:
            raise AssertionError(f"flush 2: {len(names2)} series, "
                                 f"suffixes {blk2.suffixes}")
        got_b = _dd_scan(recv_b, [b'{"metric":"lc.h.', b'"reload:2"'])
        if recv_a.bodies:
            raise AssertionError("receiver A got a body after the reload")
        rows2 = sum(len(b) for b in col2.blocks)
        if (got_b[b'{"metric":"lc.h.'] != series * len(want2)
                or got_b[b'"reload:2"'] != got_b[b'{"metric":']
                or got_b[b'{"metric":'] < rows2):
            raise AssertionError(f"receiver B got {got_b}, the blocks "
                                 f"hold {rows2} rows")
        rec["flush2_series_at_b"] = got_b[b'{"metric":']
        idx = np.array([int(n.rsplit(".", 1)[1]) for n in names2])
        if not np.all(mat[:, 0] == 4.0):
            raise AssertionError("a series' count is not 4")
        pick = np.random.default_rng(SEED + 92).choice(
            series, sampled, replace=False)
        worst = rank_worst = 0.0
        for r in pick.tolist():
            samples = vals[idx[r]]
            got = mat[r, 1:]
            want = _digest_reference(samples, LC_RELOAD_PCTS)
            span = float(samples.max() - samples.min())
            worst = max(worst, float(np.max(np.abs(got - want))) / span)
            srt = np.sort(samples.astype(np.float64))
            ranks = np.interp(got, srt, np.linspace(0.0, 1.0, len(srt)))
            rank_worst = max(rank_worst, float(np.max(np.abs(
                ranks - np.array(LC_RELOAD_PCTS)))))
        if worst > 0.02:
            raise AssertionError(f"percentiles after the reload off the "
                                 f"exact digest by {worst:.3g} of the span")
        rec.update(sampled=sampled, pct_err_vs_exact_digest=worst,
                   rank_err_vs_np_quantile_max=rank_worst)
        server.reload(new)
        if not closed:
            raise AssertionError("A's sink did not close at the next "
                                 "reload")
    finally:
        logging.getLogger("veneur.server").removeHandler(catch)
        server.shutdown()
        recv_a.close()
        recv_b.close()
    return rec, counts


def _lc_vars(port: int) -> dict:
    status, body = _http_get(port, "/debug/vars", timeout=10)
    if status != 200:
        raise AssertionError(f"/debug/vars answered {status}")
    return json.loads(body)


def _lc_port(kind) -> int:
    """A free port for a config both generations read (the replacement
    re-execs the same file, so its ports are fixed)."""
    s = socket.socket(socket.AF_INET, kind)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _lc_healthy(port: int, proc, timeout: float) -> float:
    """Seconds until ``/healthcheck`` answers 200; ``proc`` exiting or
    the timeout fails."""
    t0 = time.perf_counter()
    while True:
        try:
            if _http_get(port, "/healthcheck", timeout=2)[0] == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode}"
                                 f" before it was healthy")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("the server never became healthy")
        time.sleep(0.1)


def _lc_send(udp: int, http: int, lines, timeout: float = 300) -> int:
    """``lines`` packed into datagrams to the CLI server's lanes, paced
    by the packets its /debug/vars says they took; waits until the
    store processed every line. Returns the datagrams sent."""
    t = _pack_lines(lines)
    blob, off, ln = t["blob"], t["d_off"].tolist(), t["d_len"].tolist()
    dgrams = [blob[o:o + n] for o, n in zip(off, ln)]

    def fleet():
        return _lc_vars(http)["ingest_fleet"][0]["totals"]

    base = fleet()["packets"]
    processed0 = _lc_vars(http)["store"]["processed_this_interval"]
    _udp_send(udp, dgrams, lambda n: fleet()["packets"] >= base + n,
              per=256, timeout=timeout)
    _lc_processed(http, processed0 + len(lines), timeout)
    return len(dgrams)


def _lc_processed(http: int, n: int, timeout: float = 120) -> None:
    try:
        _wait_for(lambda: _lc_vars(http)["store"]["processed_this_interval"]
                  >= n, timeout, f"the CLI server to process {n} lines")
    except AssertionError:
        v = _lc_vars(http)
        raise AssertionError(f"the CLI server processed "
                             f"{v['store']['processed_this_interval']} of "
                             f"{n} lines; {v.get('ingest_fleet')}, "
                             f"{v.get('overload')}") from None


def _lc_log_wait(path: Path, pattern: str, timeout: float) -> re.Match:
    deadline = time.perf_counter() + timeout
    while True:
        hit = re.search(pattern, path.read_text(errors="replace"))
        if hit:
            return hit
        if time.perf_counter() > deadline:
            raise AssertionError(f"{path.name} never logged {pattern!r}")
        time.sleep(0.02)


def _lc_exposition(families: int) -> tuple:
    """A Prometheus exposition of ``families`` families (counters and
    gauges, one summary, one histogram) and its counters' values."""
    out, counters = [], {}
    n = (families - 2) // 2
    for i in range(n):
        out += [f"# TYPE lc_prom_c{i} counter",
                f'lc_prom_c{i}{{job="smoke"}} {i * 3 + 1}',
                f"# TYPE lc_prom_g{i} gauge",
                f'lc_prom_g{i}{{job="smoke"}} {i * 0.5}']
        counters[f"lc_prom_c{i}"] = i * 3 + 1
    out += ["# TYPE lc_prom_sum summary",
            'lc_prom_sum{quantile="0.5"} 1.5',
            'lc_prom_sum{quantile="0.99"} 9.5',
            "lc_prom_sum_sum 120.0", "lc_prom_sum_count 40",
            "# TYPE lc_prom_hist histogram",
            'lc_prom_hist_bucket{le="1"} 3',
            'lc_prom_hist_bucket{le="10"} 7',
            'lc_prom_hist_bucket{le="+Inf"} 9',
            "lc_prom_hist_sum 42.0", "lc_prom_hist_count 9"]
    counters.update({"lc_prom_sum.count": 40, "lc_prom_hist.count": 9})
    return "\n".join(out) + "\n", counters


class _LcOverlap:
    """A thread sending ``lc.o.<k>:1|c`` datagrams every 2 ms to the CLI
    server's port while the generations overlap; ``sent`` counts them."""

    def __init__(self, udp: int):
        self.sent = 0
        self._stop = threading.Event()
        self._udp = udp
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            while not self._stop.wait(0.002):
                tx.sendto(f"lc.o.{self.sent}:1|c".encode(),
                          ("127.0.0.1", self._udp))
                self.sent += 1

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=10)
        return self.sent


def _lc_counts(series: list) -> dict:
    """{metric: count} of the counter series a CLI generation's flush
    posted: each a rate, count / interval in float64, so the count is
    the nearest integer to rate x interval (a counter's count is one)."""
    out = {}
    for s in series:
        if s["type"] == "rate":
            x = s["points"][0][1] * LC_CLI_INTERVAL_S
            if abs(x - round(x)) > 1e-6:
                raise AssertionError(f"{s['metric']}: rate x interval "
                                     f"{x!r} is not a count")
            out[s["metric"]] = round(x)
    return out


def run_lifecycle_cli(dev, series: int = LC_CLI_SERIES) -> tuple:
    """Leg (b): the server CLI as a process on ``dev``: generation 1 of
    ``python -m veneur_tpu_torch.cli.server -f <file>`` (fixed UDP, SSF
    and http_address ports, interval 600 s, a Datadog sink at an
    in-process receiver) takes ``series`` counter and ``series``
    histogram series over UDP, metrics, an event, a service check, an
    ``-ssf`` span and a ``-command`` timing sent by ``python -m
    veneur_tpu_torch.cli.emit``, and one ``prometheus`` collect of an
    in-process exposition. SIGHUP re-reads the file (new percentiles)
    with the sockets bound; SIGUSR2 starts generation 2 beside it,
    which signals ready, and generation 1 drains with a final flush
    (K1) and exits 0. Generation 2 serves the same ports: its
    /healthcheck answers and what is sent after generation 1 exits
    flushes (K1) at its SIGTERM. Held: every counter sent before
    SIGUSR2 exact in generation 1's final flush, every counter sent
    after generation 1 exits exact in generation 2's, the histograms'
    counts and the new percentile rows; datagrams sent during the
    overlap counted and printed with the kernel's drops, not gated.
    Their launches are the children's, not counted here."""
    import signal

    import torch

    from veneur_tpu_torch.cli import prometheus as tprom

    LC_DIR.mkdir(parents=True, exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("VENEUR_READY_FD", None)
    rec = {"series": series}
    if dev.type == "cuda":
        out = subprocess.run([sys.executable, "-c", _STARTUP_PROBE],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=300, check=True)
        rec["child_startup"] = json.loads(out.stdout.splitlines()[-1])
    udp, ssf_port = _lc_port(socket.SOCK_DGRAM), _lc_port(socket.SOCK_DGRAM)
    http = _lc_port(socket.SOCK_STREAM)
    recv = _DatadogReceiver()
    cfg_path = LC_DIR / "server.yaml"
    cfg = dict(statsd_listen_addresses=[f"udp://127.0.0.1:{udp}"],
               ssf_listen_addresses=[f"udp://127.0.0.1:{ssf_port}"],
               http_address=f"127.0.0.1:{http}",
               interval=f"{int(LC_CLI_INTERVAL_S)}s",
               percentiles=list(LC_CLI_PCTS), aggregates=["count"],
               hostname="lc-cli", num_readers=2, datadog_api_key="k",
               datadog_api_hostname=recv.url)
    cfg_path.write_text(json.dumps(cfg))  # JSON is YAML
    argv = [sys.executable, "-m", "veneur_tpu_torch.cli.server", "-f",
            str(cfg_path)] + ([] if dev.type == "cuda"
                              else ["--device", "cpu"])
    log1 = LC_DIR / "gen1.log"
    gen1 = gen2 = None
    rng = np.random.default_rng(SEED + 95)
    cvals = rng.integers(1, 1000, series)
    hvals = np.round(rng.gamma(2.0, 10.0, (series, 4)), 3)
    try:
        with open(log1, "wb") as out1:
            gen1 = subprocess.Popen(argv, cwd=root, env=env, stdout=out1,
                                    stderr=subprocess.STDOUT)
        rec["gen1_start_s"] = _lc_healthy(http, gen1, 300)
        lines = [f"lc.c.{i}:{v}|c" for i, v in enumerate(cvals.tolist())]
        lines += [f"lc.h.{i}:{v}|h" for i in range(series)
                  for v in hvals[i].tolist()]
        t0 = time.perf_counter()
        rec["gen1_datagrams"] = _lc_send(udp, http, lines)
        rec["gen1_udp_s"] = time.perf_counter() - t0
        base = _lc_vars(http)["store"]["processed_this_interval"]
        emits = [
            ["-hostport", f"127.0.0.1:{udp}", "-name", "lc.emit.c",
             "-count", "3", "-tag", "via:emit"],
            ["-hostport", f"127.0.0.1:{udp}", "-name", "lc.emit.g",
             "-gauge", "2.5"],
            ["-hostport", f"127.0.0.1:{udp}", "-name", "lc.emit.t",
             "-timing", "125ms"],
            ["-hostport", f"127.0.0.1:{udp}", "-name", "lc.emit.s",
             "-set", "member-1"],
            ["-hostport", f"127.0.0.1:{udp}", "-mode", "event",
             "-e_title", "lifecycle", "-e_text", "generation 1"],
            ["-hostport", f"127.0.0.1:{udp}", "-mode", "sc", "-sc_name",
             "lc.emit.sc", "-sc_status", "1"],
            ["-hostport", f"udp://127.0.0.1:{ssf_port}", "-name",
             "lc.emit.ssf", "-count", "2", "-ssf", "-trace_id", "4242"],
            ["-hostport", f"127.0.0.1:{udp}", "-name", "lc.emit.cmd",
             "-command", "true"]]
        t0 = time.perf_counter()
        for args in emits:
            subprocess.run([sys.executable, "-m",
                            "veneur_tpu_torch.cli.emit", *args], cwd=root,
                           env=env, check=True, timeout=60)
        rec["emit_s"] = time.perf_counter() - t0
        text, prom_counters = _lc_exposition(LC_PROM_FAMILIES)
        prom = _PromEndpoint(text)
        try:
            t0 = time.perf_counter()
            rec["prometheus_packets"] = tprom.collect_once(
                prom.url, f"127.0.0.1:{udp}", [], [], "")
            rec["prometheus_s"] = time.perf_counter() - t0
        finally:
            prom.close()
        # the emits' four metric lines over UDP and the scrape's; the
        # rest (the span's sample, the timing, the service check) is
        # held at the final flush
        _lc_processed(http, base + 4 + rec["prometheus_packets"])
        cfg_path.write_text(json.dumps(dict(
            cfg, percentiles=list(LC_CLI_HUP_PCTS))))
        gen1.send_signal(signal.SIGHUP)
        _lc_log_wait(log1, r"config reloaded", 60)
        base = _lc_vars(http)["store"]["processed_this_interval"]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            tx.sendto(b"lc.hup:1|c", ("127.0.0.1", udp))
        _lc_processed(http, base + 1)
        rec["drops_before_usr2"] = _udp_drops(udp)
        if rec["drops_before_usr2"]:
            raise AssertionError(f"the kernel dropped "
                                 f"{rec['drops_before_usr2']} datagrams")
        overlap = _LcOverlap(udp)
        t_usr2 = time.perf_counter()
        gen1.send_signal(signal.SIGUSR2)
        hit = _lc_log_wait(log1, r"replacement pid (\d+) is serving", 300)
        t_ready = time.perf_counter()
        gen2 = gen2_pid = int(hit.group(1))
        drops_overlap = _udp_drops(udp)
        rc = gen1.wait(timeout=300)
        t_exit = time.perf_counter()
        if rc != 0:
            raise AssertionError(f"generation 1 exited with {rc}")
        time.sleep(0.2)
        rec.update(usr2_to_ready_s=t_ready - t_usr2,
                   ready_to_gen1_exit_s=t_exit - t_ready,
                   overlap_sent=overlap.stop(),
                   overlap_drops_seen=max(drops_overlap, _udp_drops(udp)))
        first = _dd_series(recv, take=False)
        other = [(p, zlib.decompress(b) if enc == "deflate" else b)
                 for p, b, enc in recv.bodies if p != "/api/v1/series"]
        del recv.bodies[:]
        counts1 = _lc_counts(first)
        bad = [i for i, v in enumerate(cvals.tolist())
               if counts1.get(f"lc.c.{i}") != v]
        want = {"lc.emit.c": 3, "lc.emit.ssf": 2, "lc.hup": 1,
                **prom_counters}
        bad += [k for k, v in want.items() if counts1.get(k) != v]
        if bad:
            raise AssertionError(f"generation 1's final flush: {len(bad)} "
                                 f"counters off, first {bad[:5]}")
        hist1 = {s["metric"]: s["points"][0][1] for s in first
                 if s["metric"].startswith("lc.h.")}
        pct_names = [f".{int(p * 100)}percentile" for p in LC_CLI_HUP_PCTS]
        if (sum(1 for k in hist1 if k.endswith(".count"))
                != series or any(counts1.get(f"lc.h.{i}.count") != 4
                                 for i in range(series))
                or any(f"lc.h.{i}{p}" not in hist1
                       for i in range(0, series, 97) for p in pct_names)):
            raise AssertionError("generation 1's histograms: a count off "
                                 "4 or a percentile row of the SIGHUP "
                                 "file missing")
        names1 = {s["metric"] for s in first}
        if not ({"lc.emit.g", "lc.emit.s", "lc.emit.t.count",
                 "lc.emit.cmd.count"} <= names1
                and any(p == "/intake" and b"lifecycle" in b
                        for p, b in other)
                and any(p == "/api/v1/check_run" and b"lc.emit.sc" in b
                        for p, b in other)):
            raise AssertionError("an emitted metric, the event or the "
                                 "service check is missing")
        rec["gen1_final_flush_series"] = len(first)
        rec["gen2_healthy_s"] = _lc_healthy(http, None, 60)
        base = _lc_vars(http)["ingest_fleet"][0]["totals"]["packets"]
        avals = rng.integers(1, 1000, series)
        gvals = np.round(rng.gamma(2.0, 10.0, (LC_GEN2_HISTS, 4)), 3)
        lines = [f"lc.a.{i}:{v}|c" for i, v in enumerate(avals.tolist())]
        lines += [f"lc.a.h.{i}:{v}|h" for i in range(LC_GEN2_HISTS)
                  for v in gvals[i].tolist()]
        t0 = time.perf_counter()
        rec["gen2_datagrams"] = _lc_send(udp, http, lines)
        rec["gen2_udp_s"] = time.perf_counter() - t0
        rec["gen2_packets_before_feed"] = base
        t0 = time.perf_counter()
        os.kill(gen2_pid, signal.SIGTERM)
        _wait_for(lambda: not _pid_alive(gen2_pid), 300,
                  "generation 2 to exit")
        rec["gen2_sigterm_to_exit_s"] = time.perf_counter() - t0
        gen2 = None
        second = _dd_series(recv)
        counts2 = _lc_counts(second)
        bad = [i for i, v in enumerate(avals.tolist())
               if counts2.get(f"lc.a.{i}") != v]
        hist2 = {s["metric"] for s in second
                 if s["metric"].startswith("lc.a.h.")}
        if bad or any(f"lc.a.h.{i}{p}" not in hist2
                      for i in range(LC_GEN2_HISTS) for p in pct_names):
            raise AssertionError(f"generation 2's flush: {len(bad)} "
                                 f"counters off or a percentile row "
                                 f"missing")
        got = sum(v for c in (counts1, counts2) for k, v in c.items()
                  if k.startswith("lc.o."))
        rec.update(gen2_final_flush_series=len(second),
                   overlap_in_gen1=sum(v for k, v in counts1.items()
                                       if k.startswith("lc.o.")),
                   overlap_in_gen2=sum(v for k, v in counts2.items()
                                       if k.startswith("lc.o.")),
                   overlap_lost=rec["overlap_sent"] - got)
    finally:
        for proc in (gen1,):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        if gen2 is not None and _pid_alive(gen2):
            os.kill(gen2, signal.SIGKILL)
        recv.close()
    return rec, {}


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie of ours counts as gone
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


class _PromEndpoint:
    """An in-process /metrics endpoint serving one exposition."""

    def __init__(self, text: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        body = text.encode()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/metrics"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def run_lifecycle_forward_faults(dev, series: int = LC_FWD_SERIES) -> tuple:
    """Leg (c), the forward: two port locals of ``series`` histogram
    series x 8 samples each (local 2's shifted +1,000, so the global's
    import drains meet rows that hold local 1's and run K2) forward
    over HTTP to a port global with 30% http_5xx, connect and timeout
    faults on forward.http (one seed, retries enough to deliver). The
    same bodies go, fault-free, to a twin global (uncounted). After one
    interval each global flushes (K1): the faulted global's rows are
    bit for bit the twin's, with the injected faults and retries
    printed and no forward error. Returns the record and the launch
    counts (the locals' flushes, the global's imports and flush)."""
    from veneur_tpu_torch import flusher
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.forward.http_forward import HTTPForwarder
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.server import Server

    rng = np.random.default_rng(SEED + 97)
    vals = [rng.gamma(2.0, 10.0, (series, 8)),
            1000.0 + rng.gamma(2.0, 10.0, (series, 8))]
    common = dict(interval="86400s", percentiles=list(PERCENTILES),
                  aggregates=["min", "max", "count"],
                  max_series=INGEST_MAX_SERIES)
    sinks = {k: _ColumnarRecorder() for k in ("global", "twin")}
    globs = {k: Server(Config(http_address="127.0.0.1:0", hostname="lc-g",
                              http_import_workers=1, **common),
                       metric_sinks=[sinks[k]], device=dev)
             for k in ("global", "twin")}
    locals_ = []
    rec = {"series": series, "kinds": "http_5xx,connect,timeout",
           "rate": 0.3, "seed": LC_FWD_SEED}
    counts = {}
    try:
        for g in globs.values():
            g.start()
        clean = HTTPForwarder(
            f"http://127.0.0.1:{globs['twin'].ops_server.port}",
            timeout=600.0)
        for k in range(2):
            local = Server(Config(
                forward_address=(f"http://127.0.0.1:"
                                 f"{globs['global'].ops_server.port}"),
                hostname=f"lc-l{k}", flush_streaming=False,
                forward_timeout="600s", retry_max=8,
                retry_base_interval="1ms", fault_injection_rate=0.3,
                fault_injection_seed=LC_FWD_SEED,
                fault_injection_kinds="http_5xx,connect,timeout",
                fault_injection_scope="forward.http", **common),
                metric_sinks=[_ColumnarRecorder()], device=dev)
            locals_.append(local)
            local.start()
            _lc_feed(local, "lc.f.", vals[k])
            states = []
            real = local.forward_fn

            def forward(state, deadline=None, parent_span=None,
                        trace_ctx=None, real=real, states=states):
                states.append(state)
                return real(state, deadline=deadline)

            local.forward_fn = forward
            _reset_counts(tc)
            t0 = time.perf_counter()
            flusher.flush_once(local)
            if local.wait_forward(600) is not True:
                raise AssertionError(f"local {k}'s faulted forward failed")
            pool = globs["global"].ops_server.import_pool
            _wait_for(lambda: pool.merged_batches >= k + 1, 600,
                      "the global to merge the faulted forward")
            rec[f"local{k}_flush_forward_import_s"] = \
                time.perf_counter() - t0
            _add_counts(counts, _counts(tc))
            fwd = local.forwarder
            rec[f"local{k}"] = {"injected": dict(fwd._faults.injected),
                                "attempts": fwd._faults.calls,
                                "retries": fwd.retries,
                                "errors": fwd.errors,
                                "forwarded": fwd.forwarded}
            if fwd.errors:
                raise AssertionError(f"local {k}: {fwd.errors} forward "
                                     f"errors under the faults")
            with _uncounted(tc):
                twin_pool = globs["twin"].ops_server.import_pool
                if not clean.forward(states[0]):
                    raise AssertionError("the twin's forward failed")
                _wait_for(lambda: twin_pool.merged_batches >= k + 1, 600,
                          "the twin to merge the forward")
        if not sum(sum(rec[f"local{k}"]["injected"].values())
                   for k in range(2)):
            raise AssertionError("no fault was injected")
        _reset_counts(tc)
        t0 = time.perf_counter()
        flusher.flush_once(globs["global"])
        gcol = sinks["global"].flushes.get(timeout=600)
        rec["global_flush_s"] = time.perf_counter() - t0
        _add_counts(counts, _counts(tc))
        with _uncounted(tc):
            flusher.flush_once(globs["twin"])
            tcol = sinks["twin"].flushes.get(timeout=600)
        gblk, gnames, gmat = _lc_block(gcol, "lc.f.", _fha_matrix)
        tblk, tnames, tmat = _lc_block(tcol, "lc.f.", _fha_matrix)
        if (gnames != tnames or gblk.suffixes != tblk.suffixes
                or len(gnames) != series
                or not np.array_equal(gmat, tmat, equal_nan=True)):
            raise AssertionError("the faulted global's rows differ from "
                                 "the twin's")
        rec["rows_bit_equal_to_twin"] = len(gnames) * len(gblk.suffixes)
        rec["imported_metrics"] = globs["global"].imported_metrics
    finally:
        for s in locals_ + list(globs.values()):
            s.shutdown()
    return rec, counts


def run_lifecycle_ingest_faults(dev, dgrams: int = LC_INGEST_DGRAMS,
                                series: int = LC_INGEST_SERIES) -> tuple:
    """Leg (c), ingest: one Server on the per-datagram Python path
    (``ingest_lanes: -1``, ``native_ingest: false``, one reader) with
    truncate and burst at rate 0.1 takes ``dgrams`` datagrams of one
    counter and one histogram line each over ``series`` series (the
    second half's samples shifted +1,000, so the guard drains through
    K2), paced by the lines the replay says it processes, with no
    kernel drop. The checker replays the same seeded schedule on the
    same datagrams with the port's FaultInjector and parser: every
    counter's flushed value equals the replayed sum, every histogram's
    count the replayed count, and the lines that no longer parse equal
    the server's packet errors and quarantines. Returns the record and
    the launch counts."""
    from veneur_tpu_torch import flusher
    from veneur_tpu_torch.config import Config
    from veneur_tpu_torch.ops import tdigest_cuda as tc
    from veneur_tpu_torch.resilience.faults import FaultInjector
    from veneur_tpu_torch.samplers import parser
    from veneur_tpu_torch.server import Server

    rng = np.random.default_rng(SEED + 99)
    ids = np.arange(dgrams) % series
    shift = np.where(np.arange(dgrams) >= dgrams // 2, 1000.0, 0.0)
    hv = np.round(rng.gamma(2.0, 10.0, dgrams) + shift, 3)
    cv = rng.integers(1, 100, dgrams)
    grams = [f"lc.i.c.{i}:{c}|c\nlc.i.h.{i}:{h}|h".encode()
             for i, c, h in zip(ids.tolist(), cv.tolist(), hv.tolist())]
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 ingest_lanes=-1, native_ingest=False, num_readers=1,
                 interval="86400s", percentiles=list(PERCENTILES),
                 aggregates=["min", "max", "count"], hostname="lc-in",
                 fault_injection_rate=0.1,
                 fault_injection_seed=LC_INGEST_SEED,
                 fault_injection_kinds="truncate,burst",
                 max_series=INGEST_MAX_SERIES)
    replay = FaultInjector(rate=0.1, seed=LC_INGEST_SEED,
                           kinds=("truncate", "burst"))
    t0 = time.perf_counter()
    counters, hcounts, errors, done = {}, {}, 0, []
    processed = 0
    for g in grams:
        for piece in replay.mangle_packet("ingest.statsd", g):
            for line in parser.split_lines(piece):
                try:
                    m = parser.parse_metric(line)
                except parser.ParseError:  # a QuarantineError too
                    errors += 1
                    continue
                processed += 1
                name = m.key.name
                if m.key.type == "counter":
                    counters[name] = counters.get(name, 0.0) \
                        + m.value / m.sample_rate
                else:
                    hcounts[name] = hcounts.get(name, 0) + 1
        done.append(processed)
    rec = {"datagrams": dgrams, "series": series,
           "replay_s": time.perf_counter() - t0,
           "replayed_injected": dict(replay.injected),
           "replayed_lines": processed, "replayed_errors": errors}
    record = _ColumnarRecorder()
    server = Server(cfg, metric_sinks=[record], device=dev)
    counts = {}
    try:
        server.start()
        if server.listeners[0][1] != "python":
            raise AssertionError(f"the listener took {server.listeners}")
        port = server.statsd_addrs[0][1]
        _reset_counts(tc)
        t0 = time.perf_counter()
        _udp_send(port, grams,
                  lambda n: server.store.processed >= done[n - 1],
                  per=256, timeout=600)
        rec["udp_s"] = time.perf_counter() - t0
        rec["kernel_drops"] = _udp_drops(port)
        if rec["kernel_drops"]:
            raise AssertionError(f"the kernel dropped {rec['kernel_drops']}"
                                 f" datagrams")
        flusher.flush_once(server)
        col = record.flushes.get(timeout=600)
        rec["flush_s"] = time.perf_counter() - t0 - rec["udp_s"]
        _add_counts(counts, _counts(tc))
        inj = server.ingest_injector
        if (dict(inj.injected) != dict(replay.injected)
                or inj.calls != replay.calls):
            raise AssertionError(f"the server's schedule {inj.injected} is "
                                 f"not the replay's {replay.injected}")
        got_errors = server.packet_errors + server.quarantined
        if got_errors != errors:
            raise AssertionError(f"{got_errors} lines rejected, the replay "
                                 f"rejects {errors}")
        _, cnames, cmat = _lc_block(col, "lc.i.c.")
        got = dict(zip(cnames, cmat[:, 0].tolist()))
        if got != counters:
            bad = [k for k in counters if got.get(k) != counters[k]]
            raise AssertionError(f"{len(bad)} counters off the replayed "
                                 f"sums, first {bad[:4]}")
        hblk, hnames, hmat = _lc_block(col, "lc.i.h.")
        ci = [s.decode() for s in hblk.suffixes].index(".count")
        if dict(zip(hnames, hmat[:, ci].tolist())) != {
                k: float(v) for k, v in hcounts.items()}:
            raise AssertionError("a histogram's count is off the replay")
        rec.update(injected=dict(inj.injected), lines_merged=processed,
                   rejected_lines=got_errors,
                   counters_checked=len(counters),
                   histograms_checked=len(hcounts))
        if not counts.get("compress_presorted.launches") and \
                dev.type == "cuda":
            raise AssertionError("the shifted samples ran no guard drain")
    finally:
        server.shutdown()
    return rec, counts


def phase_lifecycle(dev, card: str) -> dict:
    """The reload, the upgrade, the client CLIs and the fault hooks on
    the card (legs a, b, c): one line a leg, each resetting the launch
    counts before it drives its path and reading them after. Returns
    the launch counts."""
    import torch

    counts = {}
    t_phase = time.perf_counter()
    for leg, run in (("reload", lambda: run_lifecycle_reload(dev)),
                     ("cli", lambda: run_lifecycle_cli(dev)),
                     ("forward_faults",
                      lambda: run_lifecycle_forward_faults(dev)),
                     ("ingest_faults",
                      lambda: run_lifecycle_ingest_faults(dev))):
        _peak_reset(dev)
        t0 = time.perf_counter()
        rec, c = run()
        _add_counts(counts, c)
        rec.update(launches=c, peak_bytes=_peak_bytes(dev),
                   leg_s=time.perf_counter() - t0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        emit({"phase": "lifecycle", "leg": leg, "card": card, **rec})
    emit({"phase": "lifecycle", "card": card, "launches": counts,
          "phase_s": time.perf_counter() - t_phase})
    return counts


PHASES = ("store", "server", "ingest", "ssf", "heavy_hitters", "overload",
          "global_merge", "native_merge", "grpc_proxy", "fleet_trace",
          "sinks", "fleet_ha", "mesh", "server_global", "checkpoint",
          "capacity", "lifecycle")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    try:
        from veneur_tpu_torch import native
        from veneur_tpu_torch.native import egress
        from veneur_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    # no TF32 anywhere: every comparison on the card is in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # g++ (the native ingest and egress libraries, one process each)
    # beside nvcc (the kernels)
    gxx = {}

    def build_native(name, build):
        t = time.perf_counter()
        try:
            gxx[name] = str(build())
        finally:
            gxx[f"{name}_seconds"] = time.perf_counter() - t

    gxx_threads = [threading.Thread(target=build_native, args=args)
                   for args in (("veneur_ingest", native.build),
                                ("veneur_egress", egress.build))]
    for th in gxx_threads:
        th.start()
    t0 = time.perf_counter()
    logs = cuda_build.build()
    nvcc_s = time.perf_counter() - t0
    for th in gxx_threads:
        th.join()
    if not ("veneur_ingest" in gxx and native.available()):
        raise RuntimeError("the native ingest library did not build")
    if not ("veneur_egress" in gxx and egress.available()):
        raise RuntimeError("the native egress library did not build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": nvcc_s,
          "gxx_seconds": {k: gxx[f"{k}_seconds"]
                          for k in ("veneur_ingest", "veneur_egress")},
          "built": sorted(logs) + ["veneur_ingest", "veneur_egress"],
          "ptxas": _ptxas_summary(logs)})
    card = card_line()
    runs = {"store": lambda: phase_store(dev, rows=STORE_ROWS),
            "server": lambda: phase_server(dev),
            "ingest": lambda: phase_ingest(dev, card),
            "ssf": lambda: phase_ssf(dev, card),
            "heavy_hitters": lambda: phase_heavy_hitters(dev, card),
            "overload": lambda: phase_overload(dev, card),
            "global_merge": lambda: phase_global_merge(dev, card),
            "native_merge": lambda: phase_native_merge(dev, card),
            "grpc_proxy": lambda: phase_grpc_proxy(dev, card),
            "fleet_trace": lambda: phase_fleet_trace(dev, card),
            "sinks": lambda: phase_sinks(dev, card),
            "fleet_ha": lambda: phase_fleet_ha(dev, card),
            "mesh": lambda: phase_mesh(dev, card),
            "server_global": lambda: phase_server_global(dev, card),
            "checkpoint": lambda: phase_checkpoint(dev, card),
            "capacity": lambda: phase_capacity(dev, card),
            "lifecycle": lambda: phase_lifecycle(dev, card)}
    kern = phase_kernels(dev)
    # the main path's launches: each phase resets the counts just before
    # it drives its path and reads them just after; and no store of any
    # phase may leave the kernel for its plain version (the compute
    # ladder's subphase, which does so on purpose, excepted)
    _track_breakers()
    launches = {key: 0 for key in (f"{fn}.{c}" for fn in (
        "drain_quantile", "compress_presorted") for c in _COUNTERS)}
    stores = {}
    for name in PHASES:
        for key, n in (runs[name]() or {}).items():
            launches[key] += n
        stores[name] = _check_breakers(name)
    emit({"phase": "no_fallback", "stores_checked": stores})
    emit({"phase": "late_capture", **_late_capture(dev)})
    emit({"kernels": _kernel_rows(kern, launches)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
