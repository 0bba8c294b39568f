// bump-time: one-shot wall-clock jump by <delta> milliseconds.
//
// TPU-rebuild of the reference helper (jepsen/resources/bump-time.c:6-47):
// same CLI, exit codes (usage/gettimeofday -> 1, settimeofday -> 2) and
// microsecond-normalization behavior. Kept as a tiny standalone binary,
// compiled *on the DB node* by jepsen_tpu.nemesis.time, because clock
// faults need syscall precision and must work when the package manager is
// broken.
//
// usage: bump-time <delta-ms>

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

  const int64_t delta_total_us =
      static_cast<int64_t>(std::atof(argv[1]) * 1000.0);
  const int64_t delta_us = delta_total_us % 1000000;
  const int64_t delta_s = (delta_total_us - delta_us) / 1000000;

  struct timeval now;
  struct timezone tz;
  if (gettimeofday(&now, &tz) != 0) {
    std::perror("gettimeofday");
    return 1;
  }

  now.tv_sec += delta_s;
  now.tv_usec += delta_us;
  while (now.tv_usec < 0) {
    now.tv_sec -= 1;
    now.tv_usec += 1000000;
  }
  while (now.tv_usec >= 1000000) {
    now.tv_sec += 1;
    now.tv_usec -= 1000000;
  }

  if (settimeofday(&now, &tz) != 0) {
    std::perror("settimeofday");
    return 2;
  }
  return 0;
}
