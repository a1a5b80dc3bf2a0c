"""Block sync — fast replay of committed blocks from peers (reference
internal/blocksync/v0/; channel 0x40; the port of
tendermint_tpu/blocksync/).

The reference's one-block-at-a-time poolRoutine (reactor.go:439) becomes
a fetch → sign-bytes → range-batch verify → apply pipeline, where a
whole window of commits is verified in one batched call
(types/validation.verify_commit_range)."""

BLOCKSYNC_CHANNEL = 0x40
