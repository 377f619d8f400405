"""pair_decode_ms.train: the mean host-clock ms a training step spends in
the ``global`` and dense modes' pair decode (the program's
``pair_decode.forward`` span, K6's launch, and ``pair_decode.backward``,
the chunked recompute), less the waits for the card inside them (their
``sync.*`` spans: ``sync.pair_rows``, which ``sync_wait_ms.train``
counts), over the steps of the traced stretch. None where the program
keeps no such spans."""

from benchmark.harness.span_reads import own_ms

NAMES = ("pair_decode.forward", "pair_decode.backward")


def read(run):
    return own_ms(run, NAMES)
