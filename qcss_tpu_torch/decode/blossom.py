"""Exact maximum-weight general matching (blossom algorithm).

This is the primal-dual O(V^3) blossom method (Edmonds 1965, as organized
in Galil's 1986 survey "Efficient algorithms for finding maximum matching
in graphs"): maintain vertex/blossom dual variables, grow alternating
trees from free vertices, shrink odd cycles into blossoms, expand
zero-dual T-blossoms, and augment along tight paths. With
``maxcardinality=True`` it returns a maximum-weight matching among
maximum-cardinality matchings, which turns weight negation into exact
MINIMUM-weight perfect matching — the decoder-side entry point
(`min_weight_perfect_matching`).

The internal organization — the endpoint/neighbend adjacency encoding,
label/labelend tree bookkeeping, and the assign_label / scan_blossom /
add_blossom / expand_blossom / augment_blossom routine decomposition —
follows Joris van Rantwijk's classic public-domain ``mwmatching.py``
scheme (also the basis of NetworkX's ``max_weight_matching``), the
de-facto standard software formulation of Galil's presentation.

Used by `decode.mwpm.MWPMDecoder` for production exact matching at any
defect count (the bitmask-DP oracle in the same module caps at ~16
defects). Differentially tested against that oracle on random weighted
graphs in tests/test_mwpm.py.

(No reference counterpart — the reference's only decoder is a dense
syndrome LUT, css_code.py:649-735.)
"""

from __future__ import annotations


def max_weight_matching(
    nvertex: int,
    edgelist: list[tuple[int, int, int]],
    maxcardinality: bool = True,
) -> list[int]:
    """Maximum-weight matching on a general graph.

    ``edgelist`` holds (i, j, weight) with 0 <= i != j < nvertex and
    *integer* weights (possibly negative). Returns ``mate`` with
    ``mate[v]`` the matched partner of v or -1. With
    ``maxcardinality=True`` the matching has maximum cardinality among
    all matchings, and maximum weight among those.
    """
    if nvertex == 0 or not edgelist:
        return [-1] * nvertex
    edges = [(int(i), int(j), int(w)) for (i, j, w) in edgelist]
    for (i, j, _w) in edges:
        if i == j or not (0 <= i < nvertex) or not (0 <= j < nvertex):
            raise ValueError(f"bad edge ({i}, {j})")
    nedge = len(edges)
    maxweight = max(0, max(w for (_, _, w) in edges))

    # Endpoint p (0 <= p < 2*nedge) is vertex edges[p//2][p%2]; p^1 is the
    # other end of the same edge.
    endpoint = [edges[p // 2][p % 2] for p in range(2 * nedge)]
    # neighbend[v]: remote endpoints of v's incident edges.
    neighbend: list[list[int]] = [[] for _ in range(nvertex)]
    for k, (i, j, _w) in enumerate(edges):
        neighbend[i].append(2 * k + 1)
        neighbend[j].append(2 * k)

    # mate[v]: remote endpoint of v's matched edge, or -1.
    mate = [-1] * nvertex
    # Top-level blossom labels: 0 free, 1 = S (even), 2 = T (odd);
    # labelend[b] the endpoint through which b got its label.
    label = [0] * (2 * nvertex)
    labelend = [-1] * (2 * nvertex)
    # inblossom[v]: top-level blossom containing vertex v.
    inblossom = list(range(nvertex))
    blossomparent = [-1] * (2 * nvertex)
    blossomchilds: list[list[int] | None] = [None] * (2 * nvertex)
    blossombase = list(range(nvertex)) + [-1] * nvertex
    blossomendps: list[list[int] | None] = [None] * (2 * nvertex)
    # Least-slack edge tracking for the dual updates.
    bestedge = [-1] * (2 * nvertex)
    blossombestedges: list[list[int] | None] = [None] * (2 * nvertex)
    unusedblossoms = list(range(nvertex, 2 * nvertex))
    dualvar = [maxweight] * nvertex + [0] * nvertex
    allowedge = [False] * nedge
    queue: list[int] = []

    def slack(k: int) -> int:
        (i, j, w) = edges[k]
        return dualvar[i] + dualvar[j] - 2 * w

    def blossom_leaves(b: int):
        if b < nvertex:
            yield b
        else:
            for t in blossomchilds[b]:
                if t < nvertex:
                    yield t
                else:
                    yield from blossom_leaves(t)

    def assign_label(w: int, t: int, p: int) -> None:
        b = inblossom[w]
        assert label[w] == 0 and label[b] == 0
        label[w] = label[b] = t
        labelend[w] = labelend[b] = p
        bestedge[w] = bestedge[b] = -1
        if t == 1:
            queue.extend(blossom_leaves(b))
        else:  # t == 2: the mate of b's base becomes S
            base = blossombase[b]
            assert mate[base] >= 0
            assign_label(endpoint[mate[base]], 1, mate[base] ^ 1)

    def scan_blossom(v: int, w: int) -> int:
        """Trace back from v and w to find either the base of a new
        blossom (returned) or an augmenting path (-1)."""
        path = []
        base = -1
        while v != -1 or w != -1:
            b = inblossom[v]
            if label[b] & 4:
                base = blossombase[b]
                break
            assert label[b] == 1
            path.append(b)
            label[b] = 5  # breadcrumb
            assert labelend[b] == mate[blossombase[b]]
            if labelend[b] == -1:
                v = -1  # reached a tree root (single free vertex)
            else:
                v = endpoint[labelend[b]]
                b = inblossom[v]
                assert label[b] == 2
                assert labelend[b] >= 0
                v = endpoint[labelend[b]]
            if w != -1:
                v, w = w, v
        for b in path:
            label[b] = 1
        return base

    def add_blossom(base: int, k: int) -> None:
        """Shrink the odd cycle through edge k with the given base into a
        new blossom."""
        (v, w, _wt) = edges[k]
        bb = inblossom[base]
        bv = inblossom[v]
        bw = inblossom[w]
        b = unusedblossoms.pop()
        blossombase[b] = base
        blossomparent[b] = -1
        blossomparent[bb] = b
        path: list[int] = []
        endps: list[int] = []
        while bv != bb:  # v's side, base-ward
            blossomparent[bv] = b
            path.append(bv)
            endps.append(labelend[bv])
            assert label[bv] == 2 or (
                label[bv] == 1 and labelend[bv] == mate[blossombase[bv]]
            )
            assert labelend[bv] >= 0
            v = endpoint[labelend[bv]]
            bv = inblossom[v]
        path.append(bb)
        path.reverse()
        endps.reverse()
        endps.append(2 * k)
        while bw != bb:  # w's side, outward
            blossomparent[bw] = b
            path.append(bw)
            endps.append(labelend[bw] ^ 1)
            assert label[bw] == 2 or (
                label[bw] == 1 and labelend[bw] == mate[blossombase[bw]]
            )
            assert labelend[bw] >= 0
            w = endpoint[labelend[bw]]
            bw = inblossom[w]
        blossomchilds[b] = path
        blossomendps[b] = endps
        assert label[bb] == 1
        label[b] = 1
        labelend[b] = labelend[bb]
        dualvar[b] = 0
        for leaf in blossom_leaves(b):
            if label[inblossom[leaf]] == 2:
                # former T-vertex, now inside an S-blossom: scan it
                queue.append(leaf)
            inblossom[leaf] = b
        # Merge least-slack-edge lists of the sub-blossoms.
        bestedgeto = [-1] * (2 * nvertex)
        for bv in path:
            if blossombestedges[bv] is None:
                nblists = [
                    [p // 2 for p in neighbend[leaf]]
                    for leaf in blossom_leaves(bv)
                ]
            else:
                nblists = [blossombestedges[bv]]
            for nblist in nblists:
                for ke in nblist:
                    (i, j, _wt) = edges[ke]
                    if inblossom[j] == b:
                        i, j = j, i
                    bj = inblossom[j]
                    if (
                        bj != b
                        and label[bj] == 1
                        and (
                            bestedgeto[bj] == -1
                            or slack(ke) < slack(bestedgeto[bj])
                        )
                    ):
                        bestedgeto[bj] = ke
            blossombestedges[bv] = None
            bestedge[bv] = -1
        blossombestedges[b] = [ke for ke in bestedgeto if ke != -1]
        bestedge[b] = -1
        for ke in blossombestedges[b]:
            if bestedge[b] == -1 or slack(ke) < slack(bestedge[b]):
                bestedge[b] = ke

    def expand_blossom(b: int, endstage: bool) -> None:
        """Expand blossom b, promoting its children to top level."""
        for s in blossomchilds[b]:
            blossomparent[s] = -1
            if s < nvertex:
                inblossom[s] = s
            elif endstage and dualvar[s] == 0:
                expand_blossom(s, endstage)
            else:
                for leaf in blossom_leaves(s):
                    inblossom[leaf] = s
        if (not endstage) and label[b] == 2:
            # Expanding a T-blossom mid-stage: relabel the even-length
            # path from the entry child to the base, clear the rest.
            assert labelend[b] >= 0
            entrychild = inblossom[endpoint[labelend[b] ^ 1]]
            j = blossomchilds[b].index(entrychild)
            if j & 1:
                j -= len(blossomchilds[b])
                jstep = 1
                endptrick = 0
            else:
                jstep = -1
                endptrick = 1
            p = labelend[b]
            while j != 0:
                # relabel the T-sub-blossom
                label[endpoint[p ^ 1]] = 0
                label[endpoint[blossomendps[b][j - endptrick] ^ endptrick ^ 1]] = 0
                assign_label(endpoint[p ^ 1], 2, p)
                allowedge[blossomendps[b][j - endptrick] // 2] = True
                j += jstep
                p = blossomendps[b][j - endptrick] ^ endptrick
                allowedge[p // 2] = True
                j += jstep
            # base sub-blossom gets label T without recursing to its mate
            bv = blossomchilds[b][j]
            label[endpoint[p ^ 1]] = label[bv] = 2
            labelend[endpoint[p ^ 1]] = labelend[bv] = p
            bestedge[bv] = -1
            j += jstep
            while blossomchilds[b][j] != entrychild:
                bv = blossomchilds[b][j]
                if label[bv] == 1:
                    j += jstep
                    continue
                leaf = None
                for leaf in blossom_leaves(bv):
                    if label[leaf] != 0:
                        break
                if leaf is not None and label[leaf] != 0:
                    assert label[leaf] == 2
                    assert inblossom[leaf] == bv
                    label[leaf] = 0
                    label[endpoint[mate[blossombase[bv]]]] = 0
                    assign_label(leaf, 2, labelend[leaf])
                j += jstep
        label[b] = labelend[b] = -1
        blossomchilds[b] = blossomendps[b] = None
        blossombase[b] = -1
        blossombestedges[b] = None
        bestedge[b] = -1
        unusedblossoms.append(b)

    def augment_blossom(b: int, v: int) -> None:
        """Swap matched/unmatched edges along b's cycle so that v becomes
        the base."""
        t = v
        while blossomparent[t] != b:
            t = blossomparent[t]
        if t >= nvertex:
            augment_blossom(t, v)
        i = j = blossomchilds[b].index(t)
        if i & 1:
            j -= len(blossomchilds[b])
            jstep = 1
            endptrick = 0
        else:
            jstep = -1
            endptrick = 1
        while j != 0:
            j += jstep
            t = blossomchilds[b][j]
            p = blossomendps[b][j - endptrick] ^ endptrick
            if t >= nvertex:
                augment_blossom(t, endpoint[p])
            j += jstep
            t = blossomchilds[b][j]
            if t >= nvertex:
                augment_blossom(t, endpoint[p ^ 1])
            mate[endpoint[p]] = p ^ 1
            mate[endpoint[p ^ 1]] = p
        blossomchilds[b] = blossomchilds[b][i:] + blossomchilds[b][:i]
        blossomendps[b] = blossomendps[b][i:] + blossomendps[b][:i]
        blossombase[b] = blossombase[blossomchilds[b][0]]
        assert blossombase[b] == v

    def augment_matching(k: int) -> None:
        """Augment along the path through tight edge k to the two roots."""
        (v, w, _wt) = edges[k]
        for (s, p) in ((v, 2 * k + 1), (w, 2 * k)):
            while True:
                bs = inblossom[s]
                assert label[bs] == 1
                assert labelend[bs] == mate[blossombase[bs]]
                if bs >= nvertex:
                    augment_blossom(bs, s)
                mate[s] = p
                if labelend[bs] == -1:
                    break  # reached a tree root
                t = endpoint[labelend[bs]]
                bt = inblossom[t]
                assert label[bt] == 2
                assert labelend[bt] >= 0
                s = endpoint[labelend[bt]]
                j = endpoint[labelend[bt] ^ 1]
                assert blossombase[bt] == t
                if bt >= nvertex:
                    augment_blossom(bt, j)
                mate[j] = labelend[bt]
                p = labelend[bt] ^ 1

    for _stage in range(nvertex):
        label[:] = [0] * (2 * nvertex)
        bestedge[:] = [-1] * (2 * nvertex)
        for b in range(nvertex, 2 * nvertex):
            blossombestedges[b] = None
        allowedge[:] = [False] * nedge
        queue[:] = []
        for v in range(nvertex):
            if mate[v] == -1 and label[inblossom[v]] == 0:
                assign_label(v, 1, -1)
        augmented = False
        while True:
            while queue and not augmented:
                v = queue.pop()
                assert label[inblossom[v]] == 1
                for p in neighbend[v]:
                    k = p // 2
                    w = endpoint[p]
                    if inblossom[v] == inblossom[w]:
                        continue
                    kslack = 0
                    if not allowedge[k]:
                        kslack = slack(k)
                        if kslack <= 0:
                            allowedge[k] = True
                    if allowedge[k]:
                        if label[inblossom[w]] == 0:
                            assign_label(w, 2, p ^ 1)
                        elif label[inblossom[w]] == 1:
                            base = scan_blossom(v, w)
                            if base >= 0:
                                add_blossom(base, k)
                            else:
                                augment_matching(k)
                                augmented = True
                                break
                        elif label[w] == 0:
                            assert label[inblossom[w]] == 2
                            label[w] = 2
                            labelend[w] = p ^ 1
                    elif label[inblossom[w]] == 1:
                        b = inblossom[v]
                        if bestedge[b] == -1 or kslack < slack(bestedge[b]):
                            bestedge[b] = k
                    elif label[w] == 0:
                        if bestedge[w] == -1 or kslack < slack(bestedge[w]):
                            bestedge[w] = k
            if augmented:
                break

            # Dual update: the smallest of
            #   delta1 = min vertex dual (stop condition),
            #   delta2 = min slack S -> free,
            #   delta3 = half min slack S -> S,
            #   delta4 = min T-blossom dual (expand trigger).
            deltatype = -1
            delta = deltaedge = deltablossom = None
            if not maxcardinality:
                deltatype = 1
                delta = min(dualvar[:nvertex])
            for v in range(nvertex):
                if label[inblossom[v]] == 0 and bestedge[v] != -1:
                    d = slack(bestedge[v])
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 2
                        deltaedge = bestedge[v]
            for b in range(2 * nvertex):
                if (
                    blossomparent[b] == -1
                    and label[b] == 1
                    and bestedge[b] != -1
                ):
                    kslack = slack(bestedge[b])
                    assert kslack % 2 == 0
                    d = kslack // 2
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 3
                        deltaedge = bestedge[b]
            for b in range(nvertex, 2 * nvertex):
                if (
                    blossombase[b] >= 0
                    and blossomparent[b] == -1
                    and label[b] == 2
                    and (deltatype == -1 or dualvar[b] < delta)
                ):
                    delta = dualvar[b]
                    deltatype = 4
                    deltablossom = b
            if deltatype == -1:
                # No improving move: maximum-cardinality optimum reached.
                assert maxcardinality
                deltatype = 1
                delta = max(0, min(dualvar[:nvertex]))

            for v in range(nvertex):
                lb = label[inblossom[v]]
                if lb == 1:
                    dualvar[v] -= delta
                elif lb == 2:
                    dualvar[v] += delta
            for b in range(nvertex, 2 * nvertex):
                if blossombase[b] >= 0 and blossomparent[b] == -1:
                    if label[b] == 1:
                        dualvar[b] += delta
                    elif label[b] == 2:
                        dualvar[b] -= delta

            if deltatype == 1:
                break
            elif deltatype == 2:
                allowedge[deltaedge] = True
                (i, j, _wt) = edges[deltaedge]
                if label[inblossom[i]] == 0:
                    i, j = j, i
                assert label[inblossom[i]] == 1
                queue.append(i)
            elif deltatype == 3:
                allowedge[deltaedge] = True
                (i, _j, _wt) = edges[deltaedge]
                assert label[inblossom[i]] == 1
                queue.append(i)
            else:
                expand_blossom(deltablossom, False)

        if not augmented:
            break
        for b in range(nvertex, 2 * nvertex):
            if (
                blossomparent[b] == -1
                and blossombase[b] >= 0
                and label[b] == 1
                and dualvar[b] == 0
            ):
                expand_blossom(b, True)

    return [endpoint[mate[v]] if mate[v] >= 0 else -1 for v in range(nvertex)]


def min_weight_perfect_matching(
    nvertex: int, edgelist: list[tuple[int, int, int]]
) -> list[int]:
    """Exact minimum-weight PERFECT matching with integer weights.

    Negates the weights and asks for a maximum-cardinality maximum-weight
    matching; raises ValueError if no perfect matching exists."""
    if nvertex % 2:
        raise ValueError("perfect matching needs an even vertex count")
    mate = max_weight_matching(
        nvertex, [(i, j, -w) for (i, j, w) in edgelist], maxcardinality=True
    )
    if any(m < 0 for m in mate):
        raise ValueError("graph has no perfect matching")
    return mate
