"""Layered graph-layout engine (server-side).

Reference equivalent: crates/whisper-tensor-ui/src/graph_explorer/
graph_layout.rs (637 LoC): longest-path layering (`calculate_height`),
pull-up-under-children tightening, long-edge breaking into
connection-by-name src/dest stub nodes (height delta > 10), then an
iterative position refiner. Python redesign: the same structural
pipeline, but ordering within layers uses deterministic BARYCENTER
sweeps (classic Sugiyama) instead of the egui velocity integrator —
the layout computes server-side where it is testable in CI (this image
has no JS engine), and the WebUI renders the returned coordinates.

Input is the server's graph JSON (`ModelServer._graph_json`); output is
{nodes, edges, width, height} with absolute pixel coordinates.

The port's copy of whisper_tensor_tpu/server/graph_layout.py, unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# box geometry mirrors the WebUI's dag view
OP_W, OP_H = 148, 26
IO_W, IO_H = 96, 20
STUB_W, STUB_H = 110, 18
GX, GY = 22, 18
# reference graph_layout.rs:233 — edges spanning more than this many
# layers break into connection-by-name stubs
LONG_EDGE = 10
SWEEPS = 4


def _node(kind: str, ref, label: str, w: int, h: int) -> dict:
    return {"kind": kind, "ref": ref, "label": label, "w": w, "h": h,
            "inputs": [], "outputs": []}


def build_layout(graph: dict, max_ops: Optional[int] = None) -> dict:
    """graph: ModelServer._graph_json output. Returns
    {nodes: [{id,kind,ref,label,x,y,w,h}], edges: [{src,dst,tensor}],
    width, height, layers}.

    kinds mirror the reference's GraphLayoutNodeType variants: "input"
    (InputLinkNode), "constant" (ConstantLinkNode), "output"
    (OutputLinkNode), "op" (GraphNode), "conn_src"/"conn_dst"
    (ConnectionByNameSrc/Dest)."""
    ops = graph["ops"]
    if max_ops is not None:
        ops = ops[:max_ops]
    tensors = graph.get("tensors", {})

    nodes: List[dict] = []

    def add(n: dict) -> int:
        nodes.append(n)
        return len(nodes) - 1

    def tname(tid) -> str:
        t = tensors.get(str(tid))
        return t["name"] if t else f"t{tid}"

    producer: Dict[int, int] = {}   # tensor id -> node index
    consumers: Dict[int, List[int]] = {}

    # graph inputs / initializers feeding the shown ops become IO nodes
    shown_tids = set()
    for op in ops:
        shown_tids.update(t for t in op["inputs"] if t is not None)
        shown_tids.update(t for t in op["outputs"] if t is not None)
    for tid in graph.get("inputs", ()):
        if tid in shown_tids:
            producer[tid] = add(_node("input", tid, tname(tid),
                                      IO_W, IO_H))
    for tid_s, t in tensors.items():
        tid = int(tid_s)
        if t.get("kind") == "initializer" and tid in shown_tids:
            producer[tid] = add(_node("constant", tid, t["name"],
                                      IO_W, IO_H))

    op_idx = {}
    for op in ops:
        i = add(_node("op", op["id"],
                      op.get("display") or op["op_type"], OP_W, OP_H))
        op_idx[op["id"]] = i
        for t in op["outputs"]:
            if t is not None:
                producer[t] = i
        for t in op["inputs"]:
            if t is not None:
                consumers.setdefault(t, []).append(i)

    for tid in graph.get("outputs", ()):
        if tid in producer:
            consumers.setdefault(tid, []).append(
                add(_node("output", tid, tname(tid), IO_W, IO_H)))

    edges: List[Tuple[int, int, int]] = []   # (src node, dst node, tid)
    for tid, dsts in consumers.items():
        src = producer.get(tid)
        if src is None:
            continue
        for d in dsts:
            edges.append((src, d, tid))

    # -- longest-path layering (reference calculate_height) -----------
    n = len(nodes)
    height = [0] * n
    preds: Dict[int, List[int]] = {}
    succs: Dict[int, List[int]] = {}
    for s, d, _ in edges:
        preds.setdefault(d, []).append(s)
        succs.setdefault(s, []).append(d)
    # ops arrive topologically sorted (SymbolicGraph invariant), and
    # IO nodes only feed forward, so one pass in node order suffices
    for i in range(n):
        for p in preds.get(i, ()):
            height[i] = max(height[i], height[p] + 1)

    # -- pull-up-under-children (reference new(): upper_bound - 1) ----
    for i in sorted(range(n), key=lambda i: -height[i]):
        down = succs.get(i)
        if down:
            height[i] = min(height[d] for d in down) - 1

    # -- long-edge breaking into connection-by-name stubs -------------
    new_edges: List[Tuple[int, int, int]] = []
    conn_src_for: Dict[int, int] = {}
    for s, d, tid in edges:
        if height[d] - height[s] > LONG_EDGE:
            if tid not in conn_src_for:
                j = add(_node("conn_src", tid, tname(tid),
                              STUB_W, STUB_H))
                height.append(height[s] + 1)
                conn_src_for[tid] = j
                new_edges.append((s, j, tid))
            j = add(_node("conn_dst", tid, tname(tid), STUB_W, STUB_H))
            height.append(height[d] - 1)
            new_edges.append((j, d, tid))
        else:
            new_edges.append((s, d, tid))
    edges = new_edges
    n = len(nodes)

    # -- layer buckets + barycenter ordering --------------------------
    n_layers = (max(height) + 1) if n else 0
    layers: List[List[int]] = [[] for _ in range(n_layers)]
    for i in range(n):
        layers[height[i]].append(i)

    order = {i: k for layer in layers for k, i in enumerate(layer)}
    up: Dict[int, List[int]] = {}
    down: Dict[int, List[int]] = {}
    for s, d, _ in edges:
        up.setdefault(d, []).append(s)
        down.setdefault(s, []).append(d)

    def sweep(neigh: Dict[int, List[int]], rng) -> None:
        for li in rng:
            layer = layers[li]
            bary = {}
            for i in layer:
                ns = neigh.get(i)
                bary[i] = (sum(order[j] for j in ns) / len(ns)
                           if ns else order[i])
            layer.sort(key=lambda i: (bary[i], i))
            for k, i in enumerate(layer):
                order[i] = k

    for _ in range(SWEEPS):
        sweep(up, range(1, n_layers))          # downward pass
        sweep(down, range(n_layers - 2, -1, -1))  # upward pass

    # -- coordinates ---------------------------------------------------
    layer_h = [max((nodes[i]["h"] for i in layer), default=OP_H)
               for layer in layers]
    y = GY
    ys = []
    for lh in layer_h:
        ys.append(y)
        y += lh + GY
    total_w = max((sum(nodes[i]["w"] + GX for i in layer) + GX
                   for layer in layers), default=GX)
    out_nodes = []
    for li, layer in enumerate(layers):
        row_w = sum(nodes[i]["w"] + GX for i in layer) - GX
        x = max(GX, (total_w - row_w) // 2)
        for i in layer:
            nd = nodes[i]
            out_nodes.append({"id": i, "kind": nd["kind"],
                              "ref": nd["ref"], "label": nd["label"],
                              "x": int(x), "y": int(ys[li]),
                              "w": nd["w"], "h": nd["h"], "layer": li})
            x += nd["w"] + GX
    return {"nodes": out_nodes,
            "edges": [{"src": s, "dst": d, "tensor": t}
                      for s, d, t in edges],
            "width": int(total_w), "height": int(y),
            "layers": n_layers}


def count_crossings(layout: dict) -> int:
    """Edge crossings between adjacent layers (test metric: barycenter
    sweeps must not be worse than the untreated order)."""
    pos = {nd["id"]: (nd["layer"], nd["x"]) for nd in layout["nodes"]}
    by_span: Dict[int, List[Tuple[int, int]]] = {}
    for e in layout["edges"]:
        ls, xs = pos[e["src"]]
        ld, xd = pos[e["dst"]]
        if ld - ls == 1:
            by_span.setdefault(ls, []).append((xs, xd))
    total = 0
    for pairs in by_span.values():
        for a in range(len(pairs)):
            for b in range(a + 1, len(pairs)):
                (x1, y1), (x2, y2) = pairs[a], pairs[b]
                if (x1 - x2) * (y1 - y2) < 0:
                    total += 1
    return total
