"""The least time of the work the inputs need (``roofline.integrate_work``
of each traced frame's occupied bricks, bound by bytes or operations) over
the 2integrate bucket's GPU time a frame (%)."""
from recon_bench import roofline


def read(record):
    t_ms = record["buckets_ms"].get("2integrate")
    if not t_ms or not record["n_occ"]:
        return None
    least = [roofline.bound(*roofline.integrate_work(record["config"], n))[0]
             for n in record["n_occ"]]
    return 100.0 * sum(least) / len(least) * 1e3 / t_ms
