"""The span arithmetic on made-up spans."""

import pytest

from portbench import trace


def test_union_counts_each_instant_once():
    spans = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (22, 25, "d")]
    assert trace.union_us(spans) == 25
    assert trace.union_us([]) == 0


def test_attributed_gives_pdl_overlap_to_the_earlier_kernel():
    # b is started by programmatic dependent launch at 4 and waits inside
    # its span until a ends at 10; c runs alone
    spans = [(0, 10, "a"), (4, 16, "b"), (20, 25, "c")]
    got = trace.attributed_us(spans)
    assert got == {"a": 10, "b": 6, "c": 5}
    assert sum(got.values()) == trace.union_us(spans)


def test_attributed_sums_repeated_names():
    spans = [(0, 2, "k"), (3, 5, "k"), (4, 9, "m")]
    assert trace.attributed_us(spans) == {"k": 4, "m": 4}


def test_inside_splits_by_start():
    spans = [(0, 1, "a"), (5, 6, "b"), (9, 12, "c")]
    ins, outs = trace.inside(spans, [(4, 10)])
    assert [s[2] for s in ins] == ["b", "c"]
    assert [s[2] for s in outs] == ["a"]


def test_idle_gaps_named_by_innermost_host_range():
    spans = [(0, 10, "k"), (30, 40, "k"), (45, 50, "k")]
    host = [("round", 0, 60), ("save_checkpoint", 12, 28)]
    gaps = trace.idle_gaps(spans, host, 0, 60)
    assert gaps[0] == ["save_checkpoint", 20]
    assert gaps[1] == ["round", 10]
    assert gaps[2] == ["round", 5]


def test_kernel_names_and_copies():
    assert trace.kernel_name("void k_wgrad<3, 2>(float const*)") == \
        "k_wgrad<3, 2>"
    assert trace.kernel_name("void at::native::reduce_kernel<1>()") == \
        "reduce_kernel<1>()"
    assert not trace.is_kernel((0, 1, "Memcpy DtoD (Device -> Device)"))
    assert trace.is_kernel((0, 1, "k_warp"))


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, device):
        self.name, self.time_range = name, _Range(start, end)
        self.device_type = device


def test_split_events_drops_device_images_of_host_ranges():
    events = [_Event("portbench.test_boundary", 10, 20, "DeviceType.CPU"),
              _Event("portbench.test_boundary", 11, 19, "DeviceType.CUDA"),
              _Event("void k_warp(int)", 1, 3, "DeviceType.CUDA"),
              _Event("aten::mm", 1, 2, "DeviceType.CPU")]
    dev, host = trace.split_events(events)
    assert dev == [(1, 3, "k_warp")]
    assert host == [("test_boundary", 10, 20)]


@pytest.mark.parametrize("n", [1, 50])
def test_busy_intervals_merge(n):
    spans = [(i, i + 2, "k") for i in range(0, 2 * n, 2)]
    assert trace.busy_intervals(spans) == [[0, 2 * n]]
