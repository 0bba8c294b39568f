// adj-time: gradual wall-clock slew by <delta> milliseconds via adjtime(2).
//
// TPU-rebuild of the reference helper
// (cockroachdb/resources/adjtime.c:1-19): unlike bump-time's one-shot
// settimeofday jump, adjtime asks the kernel to skew the clock *smoothly*
// toward the offset — the fault a drifting-but-disciplined clock shows.
// Same CLI and exit codes (usage / adjtime failure -> 1). Compiled on the
// DB node by jepsen_tpu.nemesis.time like the other clock helpers.
//
// usage: adj-time <delta-ms>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <sys/time.h>

int main(int argc, char **argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <delta>, where delta is in ms\n",
                 argv[0]);
    return 1;
  }

  const int64_t delta_us =
      static_cast<int64_t>(std::atof(argv[1]) * 1000.0);

  struct timeval tv;
  tv.tv_sec = delta_us / 1000000;
  tv.tv_usec = delta_us % 1000000;

  if (adjtime(&tv, nullptr) != 0) {
    std::perror("adjtime");
    return 1;
  }
  return 0;
}
