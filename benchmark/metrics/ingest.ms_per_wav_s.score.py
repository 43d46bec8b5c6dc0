"""Host time in the span ``engine.native_ingest`` over the seconds of audio
ingested, in ms per second of audio."""


def read(run):
    c = run.counters
    return 1e3 * c["ingest_s"] / c["audio_s"] if c.get("audio_s") else None
