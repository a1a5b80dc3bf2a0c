"""State sync — bootstrap a fresh node from an application snapshot
instead of replaying history (the port's copy of tendermint_tpu/statesync/;
reference internal/statesync/).

Four wire channels (reference reactor.go:89-98):
  0x60 snapshot — discovery (SnapshotsRequest/Response)
  0x61 chunk — snapshot data transfer
  0x62 light-block — the p2p state provider's verification source
  0x63 params — historical consensus params

The BootFleet join wave (the reference's `statesync_fleet_scenario`) and
the Byzantine donors of statesync/byzantine.py wait for a later slice.
"""

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
LIGHT_BLOCK_CHANNEL = 0x62
PARAMS_CHANNEL = 0x63
