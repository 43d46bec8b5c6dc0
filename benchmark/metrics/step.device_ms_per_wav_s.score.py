"""Device time of the engine's batches (CUDA events on the stream from each
batch's copy to the device to its forward's last operation, the program's
``engine.batch`` records) over the seconds of audio the calls embedded, in
ms per second of audio."""

from benchmark import spans


def read(run):
    times = [r["device_ms"] for r in spans.program_log(run) or () if r["name"] == "engine.batch"]
    audio_s = run.counters.get("audio_s")
    return sum(times) / audio_s if times and audio_s else None
