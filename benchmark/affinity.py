"""Each benchmark process on the CPUs beside its card.

A card's PCI device lists the CPUs local to it in
``/sys/bus/pci/devices/<bus id>/local_cpulist``.  :func:`pin` finds the
cards' bus ids among the display controllers that the ``nvidia`` driver
holds (``/sys/bus/pci/drivers/nvidia``; ``nvidia-smi`` may read them as
``[N/A]`` in a sandbox), intersects each card's list with the
CPUs the run may use, gives the ranks whose cards list the same CPUs
disjoint contiguous slices of them, and sets every thread of the process
to its rank's slice; threads started later inherit it.  It runs before
CUDA starts (and before ``import torch`` sizes its thread pool), so the
driver's threads start on the slice too.  Where nothing can be read (a
sandbox that shows no PCI devices) it leaves the affinity as it is.
Either way it says so on stderr.  It
reads ``/sys`` and ``/proc/self`` and writes nothing there.

CUDA numbers the cards in PCI bus order here (``CUDA_DEVICE_ORDER``
``PCI_BUS_ID``, set where unset), so rank r's card r is the r-th bus id.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

PCI = Path("/sys/bus/pci/devices")
DRIVER = Path("/sys/bus/pci/drivers/nvidia")


def parse_cpulist(text: str) -> set:
    """A kernel cpulist, ``"0-15,64-79"``, as a set of CPU numbers."""
    cpus = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def cpulist(cpus) -> str:
    """The set ``cpus`` as a kernel cpulist (the inverse of
    :func:`parse_cpulist`)."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c != run[-1] + 1:
            out.append(run)
            run = []
        run.append(c)
    if run:
        out.append(run)
    return ",".join(f"{r[0]}" if len(r) == 1 else f"{r[0]}-{r[-1]}"
                    for r in out)


def card_bus_ids(driver: Path) -> list:
    """The bus ids of the display controllers under ``driver`` that CUDA
    sees, in CUDA's order (PCI bus order; ``CUDA_VISIBLE_DEVICES`` as card
    numbers picks and orders them).  Raises ValueError where that order
    cannot be known."""
    order = os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    if order != "PCI_BUS_ID":
        raise ValueError(f"CUDA_DEVICE_ORDER is {order}")
    ids = sorted(d.name for d in driver.iterdir()
                 if (d / "class").is_file()
                 and (d / "class").read_text().startswith("0x03"))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return ids
    return [ids[int(v)] for v in visible.split(",")]


def local_cpus(bus_id: str, root: Path):
    """The CPUs that the card at ``bus_id`` lists as local under ``root``
    (the PCI devices of sysfs), or None where its list cannot be read."""
    try:
        return parse_cpulist((root / bus_id / "local_cpulist").read_text())
    except (OSError, ValueError):
        return None


def share(card_cpus: list, allowed: set, rank: int) -> list:
    """Rank ``rank``'s CPUs: its card's CPUs among ``allowed``, split in
    contiguous slices among the ranks whose cards list the same CPUs, in
    rank order.  A CPU that an earlier group of ranks holds is not given
    again, so no two ranks share a CPU."""
    groups = {}
    for r, cpus in enumerate(card_cpus):
        groups.setdefault(frozenset(cpus & allowed), []).append(r)
    taken = set()
    for cpus, ranks in groups.items():
        free = sorted(cpus - taken)
        if rank in ranks:
            i, n = ranks.index(rank), len(ranks)
            return free[i * len(free) // n: (i + 1) * len(free) // n]
        taken |= cpus
    return []


def _say(text: str) -> None:
    sys.stderr.write(f"affinity: {text}\n")
    sys.stderr.flush()


def pin(rank: int = 0, world: int = 1, allowed=None):
    """Set this process to rank ``rank``'s share (:func:`share`) of the
    CPUs beside cards 0 .. world - 1, among ``allowed`` (by default the
    CPUs it may use now).  Returns the CPUs, or None where it left the
    affinity as it is."""
    allowed = set(os.sched_getaffinity(0) if allowed is None else allowed)
    try:
        cards = card_bus_ids(DRIVER)[:world]
    except (OSError, ValueError, IndexError) as e:
        _say(f"rank {rank}: left as it is, no card's bus id ({e!r}); "
             f"CPUs {cpulist(allowed)}")
        return None
    lists = [local_cpus(b, PCI) for b in cards]
    if len(cards) < world or None in lists:
        _say(f"rank {rank}: left as it is, no local_cpulist of the cards "
             f"{cards} under {PCI}; CPUs {cpulist(allowed)}")
        return None
    mine = share(lists, allowed, rank)
    if not mine:
        _say(f"rank {rank}: left as it is, card {cards[rank]} lists CPUs "
             f"{cpulist(lists[rank])}, none of them free to it among "
             f"{cpulist(allowed)}")
        return None
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except ProcessLookupError:        # the thread has ended
            pass
    _say(f"rank {rank}: CPUs {cpulist(mine)} (card {cards[rank]} lists "
         f"{cpulist(lists[rank])}; the run may use {cpulist(allowed)})")
    return mine
