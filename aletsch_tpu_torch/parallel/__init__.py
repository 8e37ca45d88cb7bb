"""The batched wave step on one device, and the cohort capture that feeds it."""
