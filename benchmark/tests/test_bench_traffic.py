"""The traffic generator: deterministic from the seed, the same work for
every seed, and the buckets and keys each mix states."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import traffic
from benchmark.reference import data as rdata
from benchmark.reference import text as rtext

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def small(m):
    """The mix with its photos at an eighth of their size (the pixels are
    not what these tests look at)."""
    return dict(m, tasks=[dict(t, sizes=[[h // 8, w // 8] for h, w in t["sizes"]])
                          for t in m["tasks"]])


@pytest.mark.parametrize("name", ["serve-odinw", "serve-coco"])
def test_serve_deterministic(name):
    m = small(mix(name))
    a, b = traffic.serve_cycle(m, BIG, CPU), traffic.serve_cycle(m, BIG, CPU)
    c = traffic.serve_cycle(m, BIG + 1, CPU)
    assert [r.labels for r in a] == [r.labels for r in b]
    assert all(np.array_equal(x, y) for r, s in zip(a, b) for x, y in zip(r.images, s.images))
    assert [r.labels for r in a] != [r.labels for r in c]

    def work(cycle):
        return Counter((tuple(im.shape for im in r.images), tuple(len(l) for l in r.labels))
                       for r in cycle)

    assert work(a) == work(c)


def keys(m, cycle):
    vocab = rtext.make_vocab(traffic.vocab_words(m))
    p = m["predictor"]
    shape_buckets = [tuple(b) for b in m["data"]["shape_buckets"]]
    out = set()
    for r in cycle:
        buckets = [rdata.pick_bucket(*rdata.shortest_edge_size(*im.shape[:2], 800, 1333),
                                     shape_buckets) for im in r.images]
        t = max(len(rtext.encode(vocab, rtext.caption(l))) for l in r.labels)
        tb = next(b for b in p["text_len_buckets"] if t <= b)
        cb = next(b for b in p["category_buckets"] if max(len(l) for l in r.labels) <= b)
        out.add((max(buckets, key=lambda b: b[0] * b[1]), tb, cb))
    return out


def fits(r, m):
    """Every image of the request fits the request's bucket."""
    buckets = [tuple(b) for b in m["data"]["shape_buckets"]]
    sizes = [rdata.shortest_edge_size(*im.shape[:2], 800, 1333) for im in r.images]
    bh, bw = max((rdata.pick_bucket(h, w, buckets) for h, w in sizes),
                 key=lambda b: b[0] * b[1])
    return all(h <= bh and w <= bw for h, w in sizes)


def test_serve_odinw_keys():
    m = mix("serve-odinw")
    cycle = traffic.serve_cycle(m, BIG, CPU)
    assert len(cycle) == 4 * len(m["tasks"]) == 52
    got = keys(m, cycle)
    assert {k[1] for k in got} == {32, 64}
    assert {k[0] for k in got} == {(800, 1216), (1216, 800), (800, 1344)}
    assert len(got) <= 16
    counts = [len(r.labels[0]) for r in cycle]
    assert min(counts) == 1 and max(counts) == 20 and 1 <= np.median(counts) <= 3
    assert all(fits(r, m) for r in cycle)
    sizes = Counter(r.images[0].shape[:2] for r in cycle)
    assert sizes[(416, 416)] == 8 and sizes[(720, 1280)] == 4 and sizes[(375, 500)] == 2
    assert sum(n for (h, w), n in sizes.items() if h > w) == 3


def test_serve_coco_keys():
    m = mix("serve-coco")
    cycle = traffic.serve_cycle(m, BIG, CPU)
    assert all(len(r.images) == 2 and all(len(l) == 80 for l in r.labels) for r in cycle)
    got = keys(m, cycle)
    assert {k[1] for k in got} == {256} and {k[2] for k in got} == {90}
    assert {k[0] for k in got} == {(800, 1216), (1216, 800)}
    for r in cycle:  # one orientation a request, COCO's 640 px long side
        assert len({im.shape[0] > im.shape[1] for im in r.images}) == 1
        assert all(max(im.shape[:2]) == 640 for im in r.images)
        assert fits(r, m)
    assert sum(r.images[0].shape[0] > r.images[0].shape[1] for r in cycle) == 2


def test_serve_mixed_orientations_refused():
    m = small(mix("serve-coco"))
    m["tasks"] = [dict(m["tasks"][0], sizes=[[60, 80], [80, 60]])]
    with pytest.raises(ValueError):
        traffic.serve_images(m)


def test_train_deterministic_and_sized():
    m = mix("train-b8")
    a, b = traffic.train_cycle(m, BIG, CPU), traffic.train_cycle(m, BIG, CPU)
    c = traffic.train_cycle(m, BIG + 1, CPU)
    assert len(a) == m["batches"] and all(len(x) == m["batch"] for x in a)
    assert all(np.array_equal(x.image, y.image) and np.array_equal(x.boxes_xyxy, y.boxes_xyxy)
               for p, q in zip(a, b) for x, y in zip(p, q))

    def work(cycle):
        return Counter(tuple(sorted((t.image.shape, len(t.names)) for t in batch))
                       for batch in cycle)

    assert work(a) == work(c)
    for batch in a:
        for t in batch:
            h, w = t.image.shape[:2]
            assert min(h, w) in m["train_short_sides"] or max(h, w) == m["max_size"]
            assert max(h, w) <= m["max_size"]
            assert len(t.labels) <= m["max_boxes"]
            assert (t.boxes_xyxy[:, 2] > t.boxes_xyxy[:, 0]).all()
            assert (t.boxes_xyxy[:, 3] > t.boxes_xyxy[:, 1]).all()
            assert t.boxes_xyxy[:, 2].max() <= w and t.boxes_xyxy[:, 3].max() <= h
