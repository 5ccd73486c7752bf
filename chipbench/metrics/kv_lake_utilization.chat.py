"""The KV lake's allocator: peak active bytes over peak reserved bytes
(``ServeEngine.memory_report``), over the run, in %."""


def read(record, profile):
    if record["kind"] != "closed_loop" or not record.get("lake_peak_reserved"):
        return None
    return record["lake_peak_active"] / record["lake_peak_reserved"] * 100
