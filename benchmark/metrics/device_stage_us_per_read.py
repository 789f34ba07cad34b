"""``DartAligner.stats["device_seed_locate_s"]`` over the window, in microseconds a
read: the seeding layer: pack, upload, the kernels' launches and the wait for them."""


def read(run):
    return 1e6 * run["stats"]["device_seed_locate_s"] / run["reads"]
