"""Admission weights of the serving plane's scheduler.

Only ``DEFAULT_CLASS_WEIGHTS`` of ``bioengine_tpu/serving/scheduler.py``
for now, which the decode loop's weighted admission reads; the
request-level scheduler itself comes with the serving plane (ROADMAP
A12).
"""

# fixed class order IS the tie-break: when several classes hold credit,
# the most latency-sensitive one goes first
DEFAULT_CLASS_WEIGHTS: dict[str, float] = {
    "interactive": 8.0,   # user-facing inference
    "bulk": 2.0,          # bulk embedding / batch jobs
    "background": 1.0,    # fine-tune / maintenance traffic
}
