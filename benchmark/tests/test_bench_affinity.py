"""Each process on the CPUs beside its card: the cpulist parser, the
disjoint split of a card's CPUs among the ranks, and the affinity left as
it is where nothing can be read."""

import os

import pytest

from benchmark import affinity as A


@pytest.mark.parametrize("text, cpus", [
    ("0-15,64-79", set(range(16)) | set(range(64, 80))),
    ("3", {3}),
    ("0,2-3,7\n", {0, 2, 3, 7}),
    ("", set()),
])
def test_cpulist_parsed_and_written_back(text, cpus):
    assert A.parse_cpulist(text) == cpus
    assert A.parse_cpulist(A.cpulist(cpus)) == cpus


def test_cpulist_written_in_ranges():
    assert A.cpulist({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"


def test_cards_in_pci_bus_order(tmp_path, monkeypatch):
    for bus, cls in (("0000:1b:00.0", "0x030200"), ("0000:05:00.0",
                     "0x030200"), ("0000:07:00.0", "0x068000")):
        (tmp_path / bus).mkdir()
        (tmp_path / bus / "class").write_text(cls + "\n")
    (tmp_path / "bind").write_text("")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    assert A.card_bus_ids(tmp_path) == ["0000:05:00.0", "0000:1b:00.0"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    assert A.card_bus_ids(tmp_path) == ["0000:1b:00.0"]
    monkeypatch.setenv("CUDA_DEVICE_ORDER", "FASTEST_FIRST")
    with pytest.raises(ValueError):
        A.card_bus_ids(tmp_path)


def test_ranks_of_one_card_list_get_disjoint_slices():
    cpus = A.parse_cpulist("0-15,64-79")
    parts = [A.share([cpus] * 4, set(range(128)), r) for r in range(4)]
    assert parts == [list(range(0, 8)), list(range(8, 16)),
                     list(range(64, 72)), list(range(72, 80))]


def test_split_follows_each_card_and_the_cpus_allowed():
    near0, near1 = set(range(0, 16)), set(range(16, 32))
    allowed = set(range(4, 28))                  # 4-15 and 16-27
    cards = [near0, near0, near1, near1]
    parts = [A.share(cards, allowed, r) for r in range(4)]
    assert parts == [list(range(4, 10)), list(range(10, 16)),
                     list(range(16, 22)), list(range(22, 28))]
    # overlapping lists: no CPU goes to two ranks
    over = [set(range(0, 8)), set(range(4, 12))]
    a, b = (A.share(over, set(range(12)), r) for r in range(2))
    assert a == list(range(8)) and b == list(range(8, 12))


def test_no_cpu_of_the_card_allowed_gives_none():
    assert A.share([set(range(8))], set(range(8, 16)), 0) == []


def test_missing_list_reads_as_none(tmp_path):
    assert A.local_cpus("0000:99:00.0", tmp_path) is None


def _fake_card(tmp_path, monkeypatch, text):
    (tmp_path / "0000:18:00.0").mkdir()
    if text is not None:
        (tmp_path / "0000:18:00.0" / "local_cpulist").write_text(text)
    monkeypatch.setattr(A, "PCI", tmp_path)
    monkeypatch.setattr(A, "card_bus_ids", lambda driver: ["0000:18:00.0"])


@pytest.fixture
def own_affinity():
    before = os.sched_getaffinity(0)
    yield before
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), before)
        except ProcessLookupError:
            pass


def test_pin_sets_the_cards_cpus(tmp_path, monkeypatch, own_affinity,
                                 capsys):
    mine = min(own_affinity)
    _fake_card(tmp_path, monkeypatch, f"{mine}\n")
    assert A.pin(0, 1) == [mine]
    assert os.sched_getaffinity(0) == {mine}
    assert f"rank 0: CPUs {mine} " in capsys.readouterr().err


@pytest.mark.parametrize("why", ["no_list", "no_driver", "none_free"])
def test_pin_leaves_the_affinity_where_nothing_can_be_read(
        why, tmp_path, monkeypatch, own_affinity, capsys):
    if why == "no_driver":
        monkeypatch.setattr(A, "DRIVER", tmp_path / "no-such-driver")
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        monkeypatch.setenv("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    else:
        _fake_card(tmp_path, monkeypatch,
                   None if why == "no_list" else f"{max(own_affinity) + 1}")
    assert A.pin(0, 1) is None
    assert os.sched_getaffinity(0) == own_affinity
    assert "left as it is" in capsys.readouterr().err
