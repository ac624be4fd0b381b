"""Shared protocol constants (copy of ``veneur_tpu/protocol/constants.py``)."""

# Magic tag keys that carry DogStatsD event fields through SSF samples
# (cf. veneur/protocol/dogstatsd/protocol.go).
EVENT_AGGREGATION_KEY_TAG = "vdogstatsd_ak"
EVENT_ALERT_TYPE_TAG = "vdogstatsd_at"
EVENT_HOSTNAME_TAG = "vdogstatsd_hostname"
EVENT_IDENTIFIER_KEY = "vdogstatsd_ev"
EVENT_PRIORITY_TAG = "vdogstatsd_pri"
EVENT_SOURCE_TYPE_TAG = "vdogstatsd_st"
