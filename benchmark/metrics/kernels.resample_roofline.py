"""Share (%) of their memory bound that the port's pull, push and pull_grad
launches reach in the profiled fit chunk: the bound is each launch reading
its input volume once and writing its output(s) once in float32 at the
cell's shapes, at the card's published bandwidth (``peaks.json``; the
float32 operations need under a third of that time), over the launches'
device time. Launches and times are the profile's kernel events, so the
share is over the launches whose time the profile holds. Every launch of
the fit maps the recon grid to an observation's upsampled grid or back; a
batched launch covers the cohort's B volumes. Each observation's upsampled
grid is the fit's: worked out from its header as the fit holds it, moved by
the program's co-registration and atlas transforms (``judge.moved_header``),
whose scale sets the ratio."""
from harness.judge import moved_header
from reference.forward import obs_geometry

# float32 volumes moved per launch, in units of (recon, upsampled) voxels
VOLUMES = {"pull": (1, 1), "push": (1, 1), "pull_grad": (1, 3)}


def upsampled_dims(subject, out, config) -> list:
    """``dim_yx`` of each observation of a fitted subject."""
    acq = config["acquisition"]
    return [obs_geometry(out["dim_y"], out["mat_y"], tuple(o["x"].shape),
                         moved_header(out, i, o["header"]), acq["profile_ip"],
                         acq["profile_tp"])["dim_yx"]
            for i, o in enumerate(subject["obs"])]


def read(record):
    p = record["profile"]
    peak = record["peaks"].get(record["device_kind"], {}).get("hbm_bytes_per_s")
    if not p or not peak:
        return None
    subject, out = record["pairs"][0]
    B = record["units"][0]["B"]
    n_y = 1
    for d in out["dim_y"]:
        n_y *= d
    n_yx = []
    for dim in upsampled_dims(subject, out, record["config"]):
        n = 1
        for d in dim:
            n *= d
        n_yx.append(n)
    bound = busy = 0.0
    for name, (a, b) in VOLUMES.items():
        events, seconds = p["kernels"].get(name, (0, 0.0))
        per = sum(4.0 * (a * n_y + b * n) for n in n_yx) / len(n_yx)
        bound += events * B * per / peak
        busy += seconds
    return 100.0 * bound / busy if busy > 0 else None
