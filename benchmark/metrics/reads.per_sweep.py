"""Linearizable reads confirmed per readIndex confirmation sweep in the
window (``server/serving/readbatch.py`` ``confirmed`` / ``sweeps``, every
server); None where no sweep fired (every read was served from the
lease)."""

from benchmark.window import total


def read(records: dict, config: dict):
    sweeps = total(records, "read_sweeps")
    if sweeps <= 0:
        return None
    return total(records, "reads_confirmed") / sweeps
