"""k1_overlap_share.sample: how far the persistent launch 1 engages, in
percent: the share of K1's (head, design) items that had a predecessor in
their block, over the run (the port's `ipa_layer.items_overlapped` over
`ipa_layer.items` counters).  The port books the counters on the host, from
the launch's shape and grid (items less one a block): they say that the
kernel's schedule gave an item another to overlap, not that the two ran at
once; a trace shows that.  None where the port keeps no such counters or
ran no persistent launch."""

from benchmark.lib.port_spans import counter


def read(rec):
    items, overlapped = counter("ipa_layer.items"), counter("ipa_layer.items_overlapped")
    if not items or overlapped is None:
        return None
    return 100.0 * overlapped / items
