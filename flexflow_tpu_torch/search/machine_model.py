"""Machine models for the search: cost of moving bytes between devices (port of
``flexflow_tpu/search/machine_model.py``).

Reference: src/runtime/machine_model.cc (SimpleMachineModel :58,
EnhancedMachineModel with config-file comm-device chains), and the fork's
topology-aware stack in src/runtime/network.cc — ConnectionMatrix over
nodes+switches, routing strategies (WeightedShortestPath / ShortestPath /
WeightedMultiplePath ECMP, include/flexflow/simulator.h:393-452), topology
generators (FlatDegConstraint / BigSwitch / FatTree / FC / custom
.topo file, simulator.h:458-581, network.cc:636-828).

TPU framing: a "node" is a host; chips within a host sit on the ICI
torus (fast, uniform); inter-host traffic rides DCN through the data-center
fabric, which is exactly what the fork's switch topologies model. The
.topo / machine-config file formats match the reference
(network_tools/debug.topo, machine_config_example) so existing files load.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..parallel.machine import MachineSpec


@dataclasses.dataclass(frozen=True)
class CommDevice:
    """One link type (reference: CommDevice in simulator.h — latency ms,
    bandwidth GB/s in config files; stored here in seconds and bytes/s)."""

    name: str
    latency: float  # seconds
    bandwidth: float  # bytes/s


class MachineModel:
    """Interface (reference: MachineModel simulator.h:224-239)."""

    version = -1

    def num_devices(self) -> int:
        raise NotImplementedError

    def comm_time(self, src_dev: int, dst_dev: int, nbytes: float) -> float:
        """Time to move nbytes from device src to device dst."""
        raise NotImplementedError

    def comm_path(self, src_dev: int, dst_dev: int) -> List[CommDevice]:
        raise NotImplementedError


class SimpleMachineModel(MachineModel):
    """v0: flat intra-node / inter-node bandwidths
    (reference: machine_model.cc:58)."""

    version = 0

    def __init__(self, machine: Optional[MachineSpec] = None):
        self.machine = machine or MachineSpec()
        c = self.machine.chip
        self.intra = CommDevice("ici", c.ici_latency, c.ici_bandwidth)
        self.inter = CommDevice("dcn", c.dcn_latency, c.dcn_bandwidth)

    def num_devices(self) -> int:
        return self.machine.num_devices

    def _same_node(self, a: int, b: int) -> bool:
        per = self.machine.devices_per_node
        return a // per == b // per

    def comm_path(self, src_dev: int, dst_dev: int) -> List[CommDevice]:
        if src_dev == dst_dev:
            return []
        return [self.intra] if self._same_node(src_dev, dst_dev) else [self.inter]

    def comm_time(self, src_dev: int, dst_dev: int, nbytes: float) -> float:
        return sum(d.latency + nbytes / d.bandwidth for d in self.comm_path(src_dev, dst_dev))


class EnhancedMachineModel(MachineModel):
    """v1: config-file machine with per-path comm-device chains
    (reference: EnhancedMachineModel simulator.h:291-388; file format =
    machine_config_example: ``key = value`` lines with latency in ms and
    bandwidth in GB/s, and ``<scope>_<mem>_to_<mem> = dev dev ...`` paths).

    On TPU we map: membus -> HBM hop, nvlink -> ICI link, nic -> DCN,
    pci -> host<->device (PCIe still real on TPU hosts). The relevant
    path for device-to-device transfers is ``*_gpu_fb_mem_to_gpu_fb_mem``
    (device memory to device memory).
    """

    version = 1

    def __init__(self, config_file: str, machine: Optional[MachineSpec] = None):
        self.machine = machine or MachineSpec()
        self.params: Dict[str, str] = {}
        with open(config_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                self.params[k.strip()] = v.strip()
        self.num_nodes = int(self.params.get("num_nodes", self.machine.num_nodes))
        self.num_sockets_per_node = int(self.params.get("num_sockets_per_node", 1))
        self.num_gpus_per_socket = int(
            self.params.get("num_gpus_per_socket", self.machine.devices_per_node)
        )
        self.devices: Dict[str, CommDevice] = {}
        for dev in ("membus", "upi", "nic", "pci", "nvlink"):
            lat = float(self.params.get(f"{dev}_latency", 0.0)) * 1e-3  # ms -> s
            bw = float(self.params.get(f"{dev}_bandwidth", 1.0)) * 1e9  # GB/s -> B/s
            self.devices[dev] = CommDevice(dev, lat, bw)
        self.paths: Dict[str, List[CommDevice]] = {}
        for key, val in self.params.items():
            if "_to_" not in key:
                continue
            chain = []
            for tok in val.split():
                base = tok.replace("_to_host", "").replace("_to_dev", "")
                if base in self.devices:
                    chain.append(self.devices[base])
            self.paths[key] = chain

    def num_devices(self) -> int:
        return self.num_nodes * self.num_sockets_per_node * self.num_gpus_per_socket

    def _scope(self, src_dev: int, dst_dev: int) -> str:
        per_socket = self.num_gpus_per_socket
        per_node = per_socket * self.num_sockets_per_node
        if src_dev // per_node != dst_dev // per_node:
            return "inter_node"
        if src_dev // per_socket != dst_dev // per_socket:
            return "inter_socket"
        return "intra_socket"

    def comm_path(self, src_dev: int, dst_dev: int) -> List[CommDevice]:
        if src_dev == dst_dev:
            return []
        key = f"{self._scope(src_dev, dst_dev)}_gpu_fb_mem_to_gpu_fb_mem"
        return self.paths.get(key, [self.devices["nvlink"]])

    def comm_time(self, src_dev: int, dst_dev: int, nbytes: float) -> float:
        path = self.comm_path(src_dev, dst_dev)
        if not path:
            return 0.0
        lat = sum(d.latency for d in path)
        bw = min(d.bandwidth for d in path)
        return lat + nbytes / bw


# --------------------------------------------------------------------------
# fork: network topology + routing
# --------------------------------------------------------------------------

ConnectionMatrix = List[List[int]]  # link multiplicity between endpoints


@dataclasses.dataclass
class NetworkTopology:
    """Adjacency over nodes + switches (reference: ConnectionMatrix,
    simulator.h:189-208; generators network.cc:636-828).

    Endpoints 0..num_nodes-1 are hosts; num_nodes..num_nodes+num_switches-1
    are switches. conn[i][j] = number of parallel links (0 = none).
    """

    num_nodes: int
    num_switches: int
    devices_per_node: int
    conn: ConnectionMatrix
    link_bandwidth: float = 25e9  # per link, bytes/s (DCN-ish default)
    link_latency: float = 10e-6

    @property
    def num_endpoints(self) -> int:
        return self.num_nodes + self.num_switches

    # ----------------------------------------------------------- loaders
    @classmethod
    def from_topo_file(cls, path: str, **kw) -> "NetworkTopology":
        """Parse the fork's .topo format (network_tools/debug.topo):
        header ``num_nodes/num_switches/gpu_per_node = N`` then one
        ``> a b c ...`` row per endpoint of the connection matrix."""
        header: Dict[str, int] = {}
        rows: List[List[int]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(">"):
                    rows.append([int(x) for x in line[1:].split()])
                elif "=" in line:
                    k, v = line.split("=", 1)
                    header[k.strip()] = int(v.strip())
        n, s = header.get("num_nodes", 1), header.get("num_switches", 0)
        g = header.get("gpu_per_node", 1)
        size = n + s
        conn = [[0] * size for _ in range(size)]
        for i, row in enumerate(rows[:size]):
            for j, v in enumerate(row[:size]):
                conn[i][j] = v
        return cls(n, s, g, conn, **kw)

    def to_topo_file(self, path: str):
        with open(path, "w") as f:
            f.write(f"num_nodes = {self.num_nodes}\n")
            f.write(f"num_switches = {self.num_switches}\n")
            f.write(f"gpu_per_node = {self.devices_per_node}\n")
            for row in self.conn:
                f.write("> " + " ".join(str(v) for v in row) + "\n")

    # -------------------------------------------------------- generators
    @classmethod
    def fully_connected(cls, num_nodes: int, devices_per_node: int = 4, **kw) -> "NetworkTopology":
        """FC topology (reference: FCTopologyGenerator network.cc)."""
        conn = [[1 if i != j else 0 for j in range(num_nodes)] for i in range(num_nodes)]
        return cls(num_nodes, 0, devices_per_node, conn, **kw)

    @classmethod
    def big_switch(cls, num_nodes: int, devices_per_node: int = 4, uplinks: int = 1, **kw) -> "NetworkTopology":
        """Single-switch star (reference: BigSwitchTopologyGenerator)."""
        size = num_nodes + 1
        conn = [[0] * size for _ in range(size)]
        for i in range(num_nodes):
            conn[i][num_nodes] = uplinks
            conn[num_nodes][i] = uplinks
        return cls(num_nodes, 1, devices_per_node, conn, **kw)

    @classmethod
    def fat_tree(cls, num_pods: int, nodes_per_pod: int, devices_per_node: int = 4, **kw) -> "NetworkTopology":
        """Two-level fat tree: per-pod leaf switch + full core layer
        (reference: FatTreeTopologyGenerator network.cc / fattree_topo.py)."""
        num_nodes = num_pods * nodes_per_pod
        num_leaf = num_pods
        num_core = max(1, num_pods // 2)
        num_switches = num_leaf + num_core
        size = num_nodes + num_switches
        conn = [[0] * size for _ in range(size)]
        for n in range(num_nodes):
            leaf = num_nodes + n // nodes_per_pod
            conn[n][leaf] = 1
            conn[leaf][n] = 1
        for l in range(num_leaf):
            for c in range(num_core):
                a, b = num_nodes + l, num_nodes + num_leaf + c
                conn[a][b] = 1
                conn[b][a] = 1
        return cls(num_nodes, num_switches, devices_per_node, conn, **kw)

    @classmethod
    def flat_deg_constraint(cls, num_nodes: int, degree: int, devices_per_node: int = 4, seed: int = 0, **kw) -> "NetworkTopology":
        """Random regular-ish graph with bounded degree
        (reference: FlatDegConstraintTopologyGenerator)."""
        rng = random.Random(seed)
        conn = [[0] * num_nodes for _ in range(num_nodes)]
        # ring for connectivity, then random extra links up to degree
        for i in range(num_nodes):
            j = (i + 1) % num_nodes
            if num_nodes > 1:
                conn[i][j] += 1
                conn[j][i] += 1
        deg = [sum(1 for v in row if v) for row in conn]
        attempts = num_nodes * degree * 4
        for _ in range(attempts):
            i, j = rng.randrange(num_nodes), rng.randrange(num_nodes)
            if i == j or conn[i][j] or deg[i] >= degree or deg[j] >= degree:
                continue
            conn[i][j] = conn[j][i] = 1
            deg[i] += 1
            deg[j] += 1
        return cls(num_nodes, 0, devices_per_node, conn, **kw)

    @classmethod
    def torus(cls, dims: Sequence[int], devices_per_node: int = 1, **kw) -> "NetworkTopology":
        """ICI-style wraparound torus over hosts (TPU-native addition:
        models an ICI slice at host granularity for DCN-free pods)."""
        n = math.prod(dims)
        conn = [[0] * n for _ in range(n)]

        def coords(i):
            out = []
            for d in reversed(dims):
                out.append(i % d)
                i //= d
            return list(reversed(out))

        def index(c):
            i = 0
            for d, x in zip(dims, c):
                i = i * d + x
            return i

        for i in range(n):
            c = coords(i)
            for ax, d in enumerate(dims):
                if d < 2:
                    continue
                for delta in (-1, 1):
                    cc = list(c)
                    cc[ax] = (cc[ax] + delta) % d
                    j = index(cc)
                    if j != i:
                        conn[i][j] = 1
        return cls(n, 0, devices_per_node, conn, **kw)


class RoutingStrategy:
    """Route finder over a NetworkTopology (reference: simulator.h:393-452)."""

    def __init__(self, topo: NetworkTopology):
        self.topo = topo

    def routes(self, src: int, dst: int) -> List[List[int]]:
        """Return one or more endpoint paths src..dst (inclusive)."""
        raise NotImplementedError

    def _dijkstra(self, src: int, dst: int, weight_fn) -> Optional[List[int]]:
        n = self.topo.num_endpoints
        dist = [math.inf] * n
        prev = [-1] * n
        dist[src] = 0.0
        pq = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if u == dst:
                break
            if d > dist[u]:
                continue
            for v in range(n):
                links = self.topo.conn[u][v]
                if not links:
                    continue
                nd = d + weight_fn(u, v, links)
                if nd < dist[v]:
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        if dist[dst] is math.inf:
            return None
        path = [dst]
        while path[-1] != src:
            p = prev[path[-1]]
            if p < 0:
                return None
            path.append(p)
        return list(reversed(path))


class ShortestPathRouting(RoutingStrategy):
    """Hop-count shortest path (reference: ShortestPathNetworkRoutingStrategy)."""

    def routes(self, src: int, dst: int) -> List[List[int]]:
        p = self._dijkstra(src, dst, lambda u, v, l: 1.0)
        return [p] if p else []


class WeightedShortestPathRouting(RoutingStrategy):
    """Shortest path weighted by inverse link multiplicity (more parallel
    links = cheaper), reference: WeightedShortestPathRoutingStrategy."""

    def routes(self, src: int, dst: int) -> List[List[int]]:
        p = self._dijkstra(src, dst, lambda u, v, l: 1.0 / l)
        return [p] if p else []


class ECMPRouting(RoutingStrategy):
    """Multiple equal-cost paths, traffic split evenly
    (reference: WeightedMultiplePathRoutingStrategy)."""

    def __init__(self, topo: NetworkTopology, max_paths: int = 4):
        super().__init__(topo)
        self.max_paths = max_paths

    def routes(self, src: int, dst: int) -> List[List[int]]:
        # k-shortest by hop count via repeated dijkstra with link removal
        paths: List[List[int]] = []
        removed: set = set()

        def w(u, v, l):
            return math.inf if (u, v) in removed else 1.0

        base = self._dijkstra(src, dst, w)
        if not base:
            return []
        paths.append(base)
        base_len = len(base)
        while len(paths) < self.max_paths:
            # remove first hop of last found path to diversify
            last = paths[-1]
            removed.add((last[0], last[1]))
            p = self._dijkstra(src, dst, w)
            if not p or len(p) > base_len:
                break
            if p not in paths:
                paths.append(p)
        return paths


class NetworkedMachineModel(MachineModel):
    """Topology-aware model (reference: NetworkedMachineModel
    simulator.h:668-758): device-to-device transfers expand to physical
    routes through the node/switch graph; per-link utilization is tracked
    so concurrent flows over a shared link see reduced bandwidth."""

    version = 2

    def __init__(
        self,
        topo: NetworkTopology,
        machine: Optional[MachineSpec] = None,
        routing: str = "weighted_shortest",
    ):
        self.topo = topo
        self.machine = machine or MachineSpec(
            num_nodes=topo.num_nodes, devices_per_node=topo.devices_per_node
        )
        if routing == "shortest":
            self.routing: RoutingStrategy = ShortestPathRouting(topo)
        elif routing == "ecmp":
            self.routing = ECMPRouting(topo)
        else:
            self.routing = WeightedShortestPathRouting(topo)
        self._route_cache: Dict[Tuple[int, int], List[List[int]]] = {}
        # per-(u,v) accumulated traffic for congestion reporting
        self.link_traffic: Dict[Tuple[int, int], float] = {}

    def num_devices(self) -> int:
        return self.topo.num_nodes * self.topo.devices_per_node

    def _node_of(self, dev: int) -> int:
        return dev // self.topo.devices_per_node

    def get_routes(self, src_node: int, dst_node: int) -> List[List[int]]:
        key = (src_node, dst_node)
        if key not in self._route_cache:
            self._route_cache[key] = self.routing.routes(src_node, dst_node)
        return self._route_cache[key]

    def comm_path(self, src_dev: int, dst_dev: int) -> List[CommDevice]:
        sn, dn = self._node_of(src_dev), self._node_of(dst_dev)
        if sn == dn:
            if src_dev == dst_dev:
                return []
            c = self.machine.chip
            return [CommDevice("ici", c.ici_latency, c.ici_bandwidth)]
        routes = self.get_routes(sn, dn)
        if not routes:
            return [CommDevice("dcn", self.topo.link_latency, self.topo.link_bandwidth)]
        path = routes[0]
        devs = []
        for u, v in zip(path, path[1:]):
            links = max(1, self.topo.conn[u][v])
            devs.append(
                CommDevice(f"link{u}-{v}", self.topo.link_latency, self.topo.link_bandwidth * links)
            )
        return devs

    def comm_time(self, src_dev: int, dst_dev: int, nbytes: float, record: bool = False) -> float:
        sn, dn = self._node_of(src_dev), self._node_of(dst_dev)
        if sn == dn:
            if src_dev == dst_dev:
                return 0.0
            c = self.machine.chip
            return c.ici_latency + nbytes / c.ici_bandwidth
        routes = self.get_routes(sn, dn)
        if not routes:
            return self.topo.link_latency + nbytes / self.topo.link_bandwidth
        # split across ECMP routes; bottleneck link decides per-route time
        share = nbytes / len(routes)
        t = 0.0
        for path in routes:
            bw = min(
                self.topo.link_bandwidth * max(1, self.topo.conn[u][v])
                for u, v in zip(path, path[1:])
            )
            lat = self.topo.link_latency * (len(path) - 1)
            t = max(t, lat + share / bw)
            if record:
                for u, v in zip(path, path[1:]):
                    self.link_traffic[(u, v)] = self.link_traffic.get((u, v), 0.0) + share
        return t


def build_machine_model(
    machine: Optional[MachineSpec] = None,
    version: int = 0,
    machine_model_file: str = "",
    topo_file: str = "",
    routing: str = "weighted_shortest",
) -> MachineModel:
    """Select the machine model the way the reference does
    (graph.cc:1908-1922 --machine-model-version/--machine-model-file,
    plus the fork's --topo-file path, model.cc:4038-4044)."""
    if topo_file:
        topo = NetworkTopology.from_topo_file(topo_file)
        return NetworkedMachineModel(topo, machine, routing)
    if version >= 1 and machine_model_file:
        return EnhancedMachineModel(machine_model_file, machine)
    return SimpleMachineModel(machine)
