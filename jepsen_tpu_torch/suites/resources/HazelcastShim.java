// Hazelcast server shim: embeds a Hazelcast member and exposes the
// framework's line protocol (see jepsen_tpu_torch/suites/hazelcast.py docstring).
//
// TPU-rebuild counterpart of the reference's server shim
// (hazelcast/server/src/jepsen/hazelcast_server.clj): TCP-IP join with the
// member list, majority quorum (reference lines 44-52), quorum-guarded
// lock/map/queue structures (54-85). Build against hazelcast.jar:
//   javac -cp hazelcast.jar HazelcastShim.java
//   jar cfe shim.jar HazelcastShim HazelcastShim*.class
// and hand the jar to HazelcastDB via test["shim-jar"].

import com.hazelcast.config.Config;
import com.hazelcast.config.QuorumConfig;
import com.hazelcast.core.Hazelcast;
import com.hazelcast.core.HazelcastInstance;

import java.io.BufferedReader;
import java.io.InputStreamReader;
import java.io.PrintWriter;
import java.net.ServerSocket;
import java.net.Socket;
import java.util.Arrays;

public class HazelcastShim {
  static HazelcastInstance hz;

  public static void main(String[] args) throws Exception {
    String members = "127.0.0.1";
    int port = 5701;
    for (int i = 0; i < args.length - 1; i++) {
      if (args[i].equals("--members")) members = args[i + 1];
      if (args[i].equals("--port")) port = Integer.parseInt(args[i + 1]);
    }

    Config config = new Config();
    // Majority quorum, as in the reference shim (hazelcast_server.clj:44-52)
    int n = members.split(",").length;
    QuorumConfig quorum = new QuorumConfig("majority", true, n / 2 + 1);
    config.addQuorumConfig(quorum);
    config.getLockConfig("jepsen.lock").setQuorumName("majority");
    config.getMapConfig("jepsen.map").setQuorumName("majority");
    config.getQueueConfig("jepsen.queue").setQuorumName("majority");
    config.getNetworkConfig().getJoin().getMulticastConfig()
        .setEnabled(false);
    config.getNetworkConfig().getJoin().getTcpIpConfig()
        .setEnabled(true).setMembers(Arrays.asList(members.split(",")));
    hz = Hazelcast.newHazelcastInstance(config);

    try (ServerSocket server = new ServerSocket(port)) {
      while (true) {
        Socket sock = server.accept();
        new Thread(() -> serve(sock)).start();
      }
    }
  }

  static void serve(Socket sock) {
    try (BufferedReader in = new BufferedReader(
             new InputStreamReader(sock.getInputStream()));
         PrintWriter out = new PrintWriter(sock.getOutputStream(), true)) {
      String line;
      while ((line = in.readLine()) != null) {
        out.println(dispatch(line.trim().split(" ")));
      }
    } catch (Exception e) {
      // connection torn down by a nemesis or client; nothing to do
    }
  }

  static String dispatch(String[] t) {
    try {
      switch (t[0]) {
        case "LOCK":
          return hz.getLock(t[1]).tryLock() ? "OK" : "FAIL";
        case "UNLOCK":
          try {
            hz.getLock(t[1]).unlock();
            return "OK";
          } catch (IllegalMonitorStateException e) {
            return "FAIL";
          }
        case "ID":
          switch (t[1]) {
            case "LONG":
              return Long.toString(
                  hz.getAtomicLong("jepsen.ids").incrementAndGet());
            case "REF": {
              // CAS loop over an atomic reference, as the reference's
              // atomic-ref-id-client does
              com.hazelcast.core.IAtomicReference<Long> ref =
                  hz.getAtomicReference("jepsen.ref-ids");
              while (true) {
                Long cur = ref.get();
                Long next = (cur == null ? 1L : cur + 1L);
                if (ref.compareAndSet(cur, next)) return next.toString();
              }
            }
            case "GEN":
              return Long.toString(
                  hz.getIdGenerator("jepsen.id-gen").newId());
          }
          return "FAIL";
        case "MAPPUT":
          hz.getMap(t[1]).put(t[2], t[3]);
          return "OK";
        case "MAPGET": {
          Object v = hz.getMap(t[1]).get(t[2]);
          return v == null ? "NIL" : v.toString();
        }
        case "MAPCAS": {
          com.hazelcast.core.IMap<Object, Object> m = hz.getMap(t[1]);
          if (t[3].equals("NIL")) {
            return m.putIfAbsent(t[2], t[4]) == null ? "OK" : "FAIL";
          }
          return m.replace(t[2], t[3], t[4]) ? "OK" : "FAIL";
        }
        case "QOFFER":
          return hz.getQueue(t[1]).offer(t[2]) ? "OK" : "FAIL";
        case "QPOLL": {
          Object v = hz.getQueue(t[1]).poll();
          return v == null ? "NIL" : v.toString();
        }
      }
      return "ERR unknown command";
    } catch (Exception e) {
      return "ERR " + e.getClass().getSimpleName();
    }
  }
}
