"""The embed solver: loss, optimizer, scheduler and the batched solve."""
